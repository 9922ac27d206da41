#!/usr/bin/env bash
# Canonical xDeepFM hyperparameters (reference run.bash:12-26):
# adam lr 1e-3, batch 4096, 50 epochs, l2 1e-5, dropout 0.1
# The PyTorch port's launcher: the JAX launcher's flags and DATA_PATH /
# OUT_DIR, on xdeepfm_tpu_torch.cli (the GPU by default). Arguments given
# to this script follow the flags (e.g. --device cpu, --use_native_parser);
# PYTHON names the interpreter (default: python).
set -euo pipefail

DATA_PATH=${DATA_PATH:-train-labeled.txt}
OUT_DIR=${OUT_DIR:-./outputs_xdeepfm}

"${PYTHON:-python}" -m xdeepfm_tpu_torch.cli.xdftrain \
  --data_path "$DATA_PATH" \
  --out_dir "$OUT_DIR" \
  --mode eval \
  --embedding_dim 10 \
  --l2_reg_embedding 1e-5 \
  --l2_reg_dnn 1e-5 \
  --dnn_dropout 0.1 \
  --learning_rate 0.001 \
  --optimizer adam \
  --epochs 50 \
  --batch_size 4096 \
  --pred_batch_size 8192 \
  --val_size 0.1 \
  --verbose 2 \
  "$@"
