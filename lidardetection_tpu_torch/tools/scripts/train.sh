#!/usr/bin/env bash
# Training on the cards of one host, a process a card (torchrun, NCCL):
#   lidardetection_tpu_torch/tools/scripts/train.sh <cards> <cfg yaml> \
#       --data_path <dataset root> [train arguments]
# Run from the repository root (the configs' _BASE_CONFIG_ paths are
# relative to it). With one card it is the single-process run.
set -e
NGPUS=$1
CFG=$2
shift 2
torchrun --standalone --nproc_per_node "$NGPUS" -m lidardetection_tpu_torch.train \
    --cfg_file "$CFG" "$@"
