#!/usr/bin/env bash
# SFG (pro) config (reference run_sfg.bash:2-12): batch 64, weight 0.1,
# positive-only, 30 epochs
# The PyTorch port's launcher: the JAX launcher's flags and DATA_PATH /
# OUT_DIR, on xdeepfm_tpu_torch.cli (the GPU by default). Arguments given
# to this script follow the flags (e.g. --device cpu, --use_native_parser);
# PYTHON names the interpreter (default: python).
set -euo pipefail

DATA_PATH=${DATA_PATH:-train-labeled.txt}
OUT_DIR=${OUT_DIR:-./outputs_xdeepfm_sfg}

"${PYTHON:-python}" -m xdeepfm_tpu_torch.cli.xdftrain_pro \
  --data_path "$DATA_PATH" \
  --out_dir "$OUT_DIR" \
  --mode eval \
  --use_sfg \
  --sfg_weight 0.1 \
  --sfg_positive_only \
  --embedding_dim 10 \
  --learning_rate 0.001 \
  --optimizer adam \
  --epochs 30 \
  --batch_size 64 \
  --verbose 2 \
  "$@"
