#!/usr/bin/env bash
# The PyTorch port's twin of go.sh: the canonical experiment (reference
# go.sh:5) on the CUDA device: 150-config crossval (cached), 8-epoch
# annealed final train, voted test, no AdaBN. Flags after the script's
# own override them (e.g. --final_epochs 2, --prediction, --platform cpu).
set -e
cd "$(dirname "$0")/.."
python -m contrastiveprosthetics_torch.cli.train \
  --final_epochs=8 --crossval_size=150 --batch_size=8 \
  --crossval_load --test --no_adabn "$@"
