"""Batch-inference CLI of the port:

    python -m focal_tpu_torch.predict -dataset MOD -model SW_Transformer \
        -learn_framework no -model_weight model.pt -input data/new_samples/ \
        -predictions_out preds.json

``-synthetic`` serves a synthetic batch instead of ``-input``; without
``-model_weight`` the weights are a seeded random init (smoke runs). Runs on
the CUDA card unless ``-device cpu`` is given; ``-pallas_mlp`` serves the
SW_Transformer with its MLPs through the fused MLP kernel (#10),
``-no_pallas_block`` with its window attention through the attention-only
kernel (#6) between the qkv and proj Linears, ``-compute_dtype bfloat16``
in bf16 (#1-bf16). Prints a latency summary
(warm-up excluded, host-device copies included) and, when the inputs carry
labels, accuracy as a sanity check.
"""

from focal_tpu_torch.data import synthetic_arrays
from focal_tpu_torch.params import parse_predict_params
from focal_tpu_torch.serve import Predictor, load_input, write_predictions


def predict(args):
    if args.input:
        data, labels, names = load_input(args.input, args.task)
    elif args.synthetic:
        data, labels, names = synthetic_arrays(
            args.dataset_config, args.task, args.synthetic_samples, seed=args.seed + 3
        )
    else:
        raise ValueError("predict needs -input <index.txt | sample dir> (or -synthetic)")

    predictor = Predictor(
        args.dataset_config, args.model, args.task, args.model_weight, args.batch_size,
        device=args.device, learn_framework=args.learn_framework, seed=args.seed,
        pallas_mlp=args.pallas_mlp, pallas_block=not args.no_pallas_block,
        compute_dtype=args.compute_dtype,
    )
    n = len(names)
    print(f"Predicting {n} samples (batch {predictor.batch_size}, "
          f"weights {predictor.checkpoint_path}, device {predictor.device})")
    result = predictor.predict(data)

    lat = result["latency"]
    print(
        f"Latency: warm-up {lat['compile_s']:.1f}s once; per batch "
        f"mean {lat['mean_s'] * 1e3:.2f} ms, p50 {lat['p50_s'] * 1e3:.2f} ms, "
        f"p99 {lat['p99_s'] * 1e3:.2f} ms -> {lat['windows_per_s']:.0f} windows/s"
    )
    labeled = labels >= 0
    if labeled.any():
        acc = float((result["preds"][labeled] == labels[labeled]).mean())
        print(f"Accuracy on the {int(labeled.sum())} labeled inputs: {acc:.5f}")

    if args.predictions_out:
        write_predictions(args.predictions_out, names, result, labels)
        print(f"Wrote {args.predictions_out}")
    else:
        for i in range(min(5, n)):
            print(f"  {names[i]}: pred={int(result['preds'][i])} p={result['probs'][i].max():.3f}")
    return result


def main(argv=None):
    return predict(parse_predict_params(argv))


if __name__ == "__main__":
    main()
