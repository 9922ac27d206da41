"""Attention-CIN xDeepFM training CLI (port of
``xdeepfm_tpu/cli/xdftrain_attn.py``; reference ``xdftrain_attn.py``).

Adds ``--model_version v1/v2`` and CIN-attention flags
(``xdftrain_attn.py:738-744``).
"""

from __future__ import annotations

from .common import base_arg_parser, run_eval, run_final
from .xdftrain import compile_args


def parse_args(argv=None):
    p = base_arg_parser()
    p.add_argument(
        "--model_version", type=str, default="v1", choices=["v1", "v2"]
    )
    p.add_argument("--cin_num_heads", type=int, default=4)
    p.add_argument("--cin_attn_dropout", type=float, default=0.0)
    p.add_argument("--cin_use_layer_norm", action="store_true", default=True)
    p.add_argument(
        "--no_cin_use_layer_norm", dest="cin_use_layer_norm", action="store_false"
    )
    p.add_argument("--cin_use_residual", action="store_true", default=True)
    p.add_argument(
        "--no_cin_use_residual", dest="cin_use_residual", action="store_false"
    )
    p.add_argument("--num_attn_layers", type=int, default=1)
    return p.parse_args(argv)


def build_model(args, linear_cols, dnn_cols, final_mode=False):
    from ..models import xDeepFMAttention, xDeepFMAttentionV2

    cls = xDeepFMAttention if args.model_version == "v1" else xDeepFMAttentionV2
    kwargs = dict(
        linear_feature_columns=linear_cols,
        dnn_feature_columns=dnn_cols,
        task="binary",
        l2_reg_embedding=args.l2_reg_embedding,
        l2_reg_dnn=args.l2_reg_dnn,
        dnn_dropout=args.dnn_dropout,
        cin_num_heads=args.cin_num_heads,
        cin_attn_dropout=args.cin_attn_dropout,
        cin_use_layer_norm=args.cin_use_layer_norm,
        cin_use_residual=args.cin_use_residual,
        device=args.device,
    )
    if args.model_version == "v2":
        kwargs["cin_num_attn_layers"] = args.num_attn_layers
    model = cls(**kwargs)
    model.compile(**compile_args(args, final_mode))
    return model


def main(argv=None):
    args = parse_args(argv)
    extra = {
        "model_version": args.model_version,
        "cin_num_heads": args.cin_num_heads,
        "num_attn_layers": args.num_attn_layers,
    }
    name = f"xdeepfm_attn_{args.model_version}"
    if args.mode == "eval":
        return run_eval(args, build_model, model_name=name, extra_config=extra)
    return run_final(args, build_model, model_name=name, extra_config=extra)


if __name__ == "__main__":
    main()
