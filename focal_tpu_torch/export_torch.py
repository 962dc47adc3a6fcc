"""Export a port checkpoint as a reference-format torch .pt file (the JAX
package's tools/export_torch.py):

    python -m focal_tpu_torch.export_torch -dataset MOD -model DeepSense \
        -learn_framework FOCAL -model_weight weights/MOD_DeepSense/exp0_contrastive_FOCAL \
        -torch_out MOD_DeepSense_pretrain.pt

``-model_weight`` is a params file (a stage's `_latest` or `_best`, or any
file saved with ``train.checkpoint.save_params``) or an experiment folder,
which resolves to the stage's `_best` file as the test CLI resolves it. The
output is a plain ``state_dict()`` the reference stack loads with its own
``weight_utils.load_model_weight`` (``utils/torch_export.py`` has the
mapping). Runs on the host alone: no device is touched.
"""

import os

import torch

from focal_tpu_torch.output_paths import checkpoint_paths
from focal_tpu_torch.params import parse_test_params
from focal_tpu_torch.utils.torch_export import export_state_dict, save_torch_state_dict


def export(args):
    """Write the reference-format file of -model_weight to -torch_out (by
    default ``{dataset}_{model}_{task}_export.pt``); returns its path."""
    path = args.model_weight
    if not path:
        raise SystemExit("No checkpoint: pass -model_weight <params file or experiment folder>")
    if os.path.isdir(path):
        args.weight_folder = path
        path = checkpoint_paths(args)[0]
    out_path = args.torch_out or f"{args.dataset}_{args.model}_{args.task}_export.pt"
    state = torch.load(path, map_location="cpu", weights_only=True)
    sd = export_state_dict(args.model, state, args.dataset_config)
    save_torch_state_dict(sd, out_path)
    n_values = sum(int(v.size) for v in sd.values())
    print(f"Exported {len(sd)} tensors ({n_values:,} values) from {path}")
    print(f"Wrote {out_path}: load in the reference with "
          f"weight_utils.load_model_weight(args, model, '{os.path.abspath(out_path)}')")
    return out_path


def main(argv=None):
    return export(parse_test_params(argv))


if __name__ == "__main__":
    main()
