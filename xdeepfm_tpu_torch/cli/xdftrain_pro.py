"""xDeepFM-Pro training CLI (port of ``xdeepfm_tpu/cli/xdftrain_pro.py``;
reference ``xdftrain_pro.py``).

Adds SFG and AutoDis flags (``xdftrain_pro.py:807-831``).
"""

from __future__ import annotations

from .common import base_arg_parser, run_eval, run_final
from .xdftrain import compile_args


def parse_args(argv=None):
    p = base_arg_parser()
    p.add_argument("--use_sfg", dest="use_sfg", action="store_true", default=True)
    p.add_argument("--no_sfg", dest="use_sfg", action="store_false")
    p.add_argument("--sfg_weight", type=float, default=0.1)
    p.add_argument(
        "--sfg_hidden_units", type=int, nargs="+", default=[128, 64]
    )
    p.add_argument("--sfg_dropout", type=float, default=0.1)
    p.add_argument(
        "--sfg_positive_only", dest="sfg_positive_only", action="store_true",
        default=True,
    )
    p.add_argument(
        "--sfg_all_samples", dest="sfg_positive_only", action="store_false"
    )
    p.add_argument(
        "--sfg_use_label_attention", action="store_true", default=True
    )
    p.add_argument(
        "--no_sfg_label_attention", dest="sfg_use_label_attention",
        action="store_false",
    )
    p.add_argument("--use_autodis", action="store_true", default=False)
    p.add_argument("--autodis_buckets", type=int, default=16)
    p.add_argument("--autodis_temperature", type=float, default=1.0)
    p.add_argument("--use_light_version", action="store_true", default=False)
    return p.parse_args(argv)


def build_model(args, linear_cols, dnn_cols, final_mode=False):
    from ..pro import xDeepFMPro, xDeepFMProLight

    cls = xDeepFMProLight if args.use_light_version else xDeepFMPro
    model = cls(
        linear_feature_columns=linear_cols,
        dnn_feature_columns=dnn_cols,
        task="binary",
        l2_reg_embedding=args.l2_reg_embedding,
        l2_reg_dnn=args.l2_reg_dnn,
        dnn_dropout=args.dnn_dropout,
        use_sfg=args.use_sfg,
        sfg_weight=args.sfg_weight,
        sfg_hidden_units=tuple(args.sfg_hidden_units),
        sfg_dropout=args.sfg_dropout,
        sfg_positive_only=args.sfg_positive_only,
        sfg_use_label_attention=args.sfg_use_label_attention,
        use_autodis=args.use_autodis,
        autodis_buckets=args.autodis_buckets,
        autodis_temperature=args.autodis_temperature,
        device=args.device,
    )
    model.compile(**compile_args(args, final_mode))
    return model


def main(argv=None):
    args = parse_args(argv)
    # pro reader variant: column-count label detection + dense coercion
    # (xdftrain_pro.py:123-190, 225-250)
    args.pro_reader = True
    extra = {
        "use_sfg": args.use_sfg,
        "sfg_weight": args.sfg_weight,
        "sfg_positive_only": args.sfg_positive_only,
        "use_autodis": args.use_autodis,
        "use_light_version": args.use_light_version,
    }
    name = "xdeepfm_pro"
    if args.mode == "eval":
        return run_eval(args, build_model, model_name=name, extra_config=extra)
    return run_final(args, build_model, model_name=name, extra_config=extra)


if __name__ == "__main__":
    main()
