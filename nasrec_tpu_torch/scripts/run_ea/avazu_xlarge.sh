#!/bin/bash
# Regularized evolution over the trained avazu supernet.
# Hyperparameters mirror the reference launcher
# (ref: nasrec/scripts/run_ea/avazu_run_ea_from_supernet_xlarge.sh); candidate
# groups of 8 are fine-tuned as one stacked program on the card instead of
# 4 GPU workers.
# PyTorch/CUDA port of scripts/run_ea/avazu_xlarge.sh:
# the same flags, run by the nasrec_tpu_torch CLI on the card.
CKPT_PATH=./experiments/supernet/avazu_xlarge_lr0.12/supernet_checkpoint.pkl

python -u -m nasrec_tpu_torch.cli.eval_subnet_from_supernet \
    --root_dir ./data/avazu_kaggle_autoctr/ \
    --dataset avazu \
    --ea_top_k 2 \
    --ckpt_path $CKPT_PATH \
    --learning_rate 0.04 \
    --n_childs 8 \
    --n_generations 240 \
    --init_population 128 \
    --sample_size 64 \
    --method regularized-ea \
    --use_layernorm 1 \
    --max_train_steps 500 \
    --train_batch_size 512 \
    --test_batch_size 8192 \
    --max_eval_steps 150 \
    --config xlarge \
    --cap_vocab 1 \
    --group_size 8 \
    --logging_dir ./experiments/ea/avazu_xlarge
