"""xDeepFM training CLI (port of ``xdeepfm_tpu/cli/xdftrain.py``; reference
``xdftrain.py``).

    python -m xdeepfm_tpu_torch.cli.xdftrain --data_path train.txt --mode eval ...
"""

from __future__ import annotations

from .common import base_arg_parser, run_eval, run_final


def compile_args(args, final_mode):
    """``compile``'s arguments from the CLI flags (shared by the CLIs)."""
    return dict(
        optimizer=args.optimizer,
        loss="binary_crossentropy",
        metrics=[] if final_mode else ["binary_crossentropy", "auc"],
        lr=args.learning_rate,
        embedding_optimizer=getattr(args, "embedding_optimizer", "dense"),
        embedding_gradient=getattr(args, "embedding_gradient", "auto"),
        embedding_layout=getattr(args, "embedding_layout", "auto"),
        embedding_state_dtype=getattr(args, "embedding_state_dtype", "float32"),
    )


def build_model(args, linear_cols, dnn_cols, final_mode=False):
    from ..models import xDeepFM

    model = xDeepFM(
        linear_feature_columns=linear_cols,
        dnn_feature_columns=dnn_cols,
        task="binary",
        l2_reg_embedding=args.l2_reg_embedding,
        l2_reg_dnn=args.l2_reg_dnn,
        dnn_dropout=args.dnn_dropout,
        device=args.device,
    )
    model.compile(**compile_args(args, final_mode))
    return model


def parse_args(argv=None):
    return base_arg_parser().parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "eval":
        return run_eval(args, build_model, model_name="xdeepfm")
    return run_final(args, build_model, model_name="xdeepfm")


if __name__ == "__main__":
    main()
