#!/usr/bin/env bash
# The PyTorch port's twin of results.sh: rebuild the best config, load
# the checkpoint, test, and write the full data/ artifact set and
# results.png, on the CUDA device.
set -e
cd "$(dirname "$0")/.."
python -m contrastiveprosthetics_torch.cli.results --no_adabn "$@"
