"""v1-compat trainer (port of ``xdeepfm_tpu/cli/xdftrain_v1.py``; reference
``xdftrain_v1.py``).

The reference's earlier revision differs from ``xdftrain.py`` by defaulting
to adagrad (``xdftrain_v1.py:637``) and by doing an in-file 3-way
train/val/test split of ``--data_path`` (``xdftrain_v1.py:322-330``) instead
of taking external eval/test files: preprocessors fit on the train split
only, validation drives early stopping/checkpointing, and the reported
metrics come from the held-out test split.
"""

from __future__ import annotations

from .common import base_arg_parser, run_eval_v1, run_final
from .xdftrain import build_model


def parse_args(argv=None):
    p = base_arg_parser()
    # reference v1 defaults (xdftrain_v1.py:637,646-647)
    p.set_defaults(optimizer="adagrad", val_size=0.2)
    p.add_argument(
        "--test_size", type=float, default=0.2,
        help="in-file test split fraction (3-way split mode)",
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "eval":
        return run_eval_v1(args, build_model, model_name="xdeepfm_v1")
    return run_final(args, build_model, model_name="xdeepfm_v1")


if __name__ == "__main__":
    main()
