#!/usr/bin/env bash
# Attention-CIN variant (reference run_attn.bash:2-7): v1, 2 heads
# The PyTorch port's launcher: the JAX launcher's flags and DATA_PATH /
# OUT_DIR, on xdeepfm_tpu_torch.cli (the GPU by default). Arguments given
# to this script follow the flags (e.g. --device cpu, --use_native_parser);
# PYTHON names the interpreter (default: python).
set -euo pipefail

DATA_PATH=${DATA_PATH:-train-labeled.txt}
OUT_DIR=${OUT_DIR:-./outputs_xdeepfm_attn}

"${PYTHON:-python}" -m xdeepfm_tpu_torch.cli.xdftrain_attn \
  --data_path "$DATA_PATH" \
  --out_dir "$OUT_DIR" \
  --mode eval \
  --model_version v1 \
  --cin_num_heads 2 \
  --embedding_dim 10 \
  --learning_rate 0.001 \
  --optimizer adam \
  --epochs 50 \
  --batch_size 4096 \
  --verbose 2 \
  "$@"
