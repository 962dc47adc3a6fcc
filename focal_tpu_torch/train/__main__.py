"""Training CLI of the port:

    python -m focal_tpu_torch.train -dataset MOD_WIDE -model SW_Transformer \
        -learn_framework FOCAL -stage pretrain -synthetic -epochs 2 -output_dir runs

FOCAL pretraining (``train.loops.pretrain``) on the CUDA card, or on the
CPU with ``-device cpu``; ``-resume`` goes on from the newest run's
`_resume` checkpoint. The supervised and finetune stages are not ported yet
(ROADMAP A4).
"""

from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train.loops import pretrain


def train(args):
    if args.train_mode == "supervised" or args.stage != "pretrain":
        raise NotImplementedError(
            f"stage {args.stage} with -learn_framework {args.learn_framework} is not ported yet: "
            "ROADMAP A4")
    return pretrain(args)


def main(argv=None):
    return train(parse_train_params(argv))


if __name__ == "__main__":
    main()
