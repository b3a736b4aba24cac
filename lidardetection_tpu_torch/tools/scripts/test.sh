#!/usr/bin/env bash
# Evaluation on the cards of one host, a process a card (torchrun, NCCL):
# each rank evaluates its shard, the main process scores the merged results.
#   lidardetection_tpu_torch/tools/scripts/test.sh <cards> <cfg yaml> \
#       --ckpt <checkpoint_epoch_<n>.pth> | --eval_all --ckpt_dir <dir>
# Run from the repository root.
set -e
NGPUS=$1
CFG=$2
shift 2
torchrun --standalone --nproc_per_node "$NGPUS" -m lidardetection_tpu_torch.tools.test \
    --cfg_file "$CFG" "$@"
