#!/bin/bash
# Ablation: any-path supernet training (WWW'23 path-sampling study).
# Ref: nasrec/scripts/train_supernet/studies/train_supernet_xlarge_criteo_anypath.sh
# PyTorch/CUDA port of scripts/train_supernet/studies/criteo_xlarge_anypath.sh:
# the same flags, run by the nasrec_tpu_torch CLI on the card.
LR=0.12
WD=0

python -u -m nasrec_tpu_torch.cli.train_supernet \
    --root_dir ./data/criteo_kaggle_autoctr \
    --dataset criteo-kaggle \
    --learning_rate $LR \
    --train_batch_size 512 \
    --strategy any-path \
    --anypath_choice binomial-0.5 \
    --test_batch_size 2048 \
    --use_layernorm 1 \
    --supernet_training_steps 15000 \
    --config xlarge \
    --num_blocks 7 \
    --num_epochs 1 \
    --test_interval 2000 \
    --cap_vocab 1 \
    --wd $WD \
    --logging_dir ./experiments/ablations-paths/criteo_xlarge_anypath_lr${LR}
