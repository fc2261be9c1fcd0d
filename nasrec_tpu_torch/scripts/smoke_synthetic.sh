#!/bin/bash
# End-to-end smoke of all four workloads on synthetic data (no datasets
# needed), on the card: the PyTorch/CUDA port of scripts/smoke_synthetic.sh.
# The JAX script's last step, `bench.py --smoke`, has no counterpart here:
# the port has no bench yet.
set -e
SMOKE_DIR=$(mktemp -d)
trap 'rm -rf "$SMOKE_DIR"' EXIT
python -u -m nasrec_tpu_torch.cli.main_train --net supernet-config \
    --arch criteo-kaggle/xlarge --data_source synthetic \
    --max_train_steps 50 --max_eval_steps 4 --test_interval 50 \
    --train_batch_size 256 --test_batch_size 512
python -u -m nasrec_tpu_torch.cli.train_supernet --config autoctr --num_blocks 3 \
    --data_source synthetic --max_train_steps 50 --max_eval_steps 4 \
    --test_interval 50 --train_batch_size 256 --test_batch_size 512 \
    --supernet_training_steps 10 --logging_dir "$SMOKE_DIR"
python -u -m nasrec_tpu_torch.cli.eval_subnet_from_supernet --config autoctr \
    --num_blocks 3 --data_source synthetic --method random --budget 4 \
    --max_train_steps 10 --max_eval_steps 2 --group_size 2 --ea_top_k 2 \
    --train_batch_size 256 --test_batch_size 512 \
    --ckpt_path "$SMOKE_DIR/supernet_checkpoint.pkl"
python -u -m nasrec_tpu_torch.cli.eval_subnet_from_scratch --config autoctr \
    --num_blocks 3 --data_source synthetic --num_subnets 2 \
    --train_batch_size 256 --test_batch_size 512 \
    --max_train_steps 10 --max_eval_steps 2 --test_interval 10
python -u -m nasrec_tpu_torch.tools.sweep_device_check
python -u -m nasrec_tpu_torch.tools.body_device_check
echo "smoke OK"
