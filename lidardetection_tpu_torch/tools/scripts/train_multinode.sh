#!/usr/bin/env bash
# Training on the cards of several hosts, a process a card (torchrun,
# NCCL); the counterpart of tools/scripts/train_tpu_pod.sh. Run it on every
# host, from the repository root (the configs' _BASE_CONFIG_ paths are
# relative to it), with the same MASTER_ADDR and MASTER_PORT (an address
# and a free port of the host with NODE_RANK 0) and the host's own
# NODE_RANK:
#   NNODES=2 NODE_RANK=<0 or 1> NGPUS=8 MASTER_ADDR=<host 0> MASTER_PORT=29500 \
#       lidardetection_tpu_torch/tools/scripts/train_multinode.sh <cfg yaml> \
#       [train arguments]
# The process of global rank 0 writes the log, the checkpoints and the
# TensorBoard scalars, and every rank resumes from the checkpoints, so the
# output directory (--output_dir, or output/ under the working directory)
# must be on storage that every host shares. --batch_size is the global
# batch over all NNODES x NGPUS processes.
set -e
CFG=$1
shift
torchrun --nnodes "$NNODES" --node_rank "$NODE_RANK" --nproc_per_node "$NGPUS" \
    --master_addr "$MASTER_ADDR" --master_port "$MASTER_PORT" \
    -m lidardetection_tpu_torch.train --cfg_file "$CFG" "$@"
