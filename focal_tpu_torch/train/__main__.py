"""Training CLI of the port:

    python -m focal_tpu_torch.train -dataset MOD -model SW_Transformer \
        -learn_framework FOCAL -stage pretrain -synthetic -epochs 2 -output_dir runs

The JAX package's three stages, dispatched as its train.py does:
``-learn_framework no`` trains a classifier (``train.loops.
supervised_train``), ``-learn_framework FOCAL`` pretrains (``-stage
pretrain``, the default) or finetunes the newest pretrained run (``-stage
finetune``). On the CUDA card, or on the CPU with ``-device cpu``;
``-resume`` goes on from the stage's `_resume` checkpoint; ``-pallas_mlp``
runs the Swin MLPs through the fused MLP kernels; ``-no_pallas_block`` runs
window attention through the attention-only kernels (#6-#9) between the qkv
and proj Linears instead of the whole-block kernels (#1-#5);
``-compute_dtype bfloat16`` trains with bf16 activations over f32
parameters, gradients and optimizer (SW_Transformer through #1-bf16 to
#3-bf16; DeepSense on cuDNN's bf16 convs, or with ``-pallas_conv`` through
#13-bf16/#14-bf16).
"""

from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train.loops import finetune, pretrain, supervised_train


def train(args):
    if args.train_mode == "supervised":
        return supervised_train(args)
    if args.stage == "pretrain":
        return pretrain(args)
    if args.stage == "finetune":
        return finetune(args)
    raise ValueError(f"Invalid stage ({args.stage}) provided.")


def main(argv=None):
    return train(parse_train_params(argv))


if __name__ == "__main__":
    main()
