"""Keras-style engine (port of ``xdeepfm_tpu/basemodel.py``; reference
``deepctr/models/basemodel.py``).

``compile`` / ``fit`` / ``evaluate`` / ``predict`` and weights I/O.  The model
runs on a CUDA device unless the caller passes ``device="cpu"``; with no GPU
present, ``device=None`` raises instead of carrying on on the CPU.

Training follows the JAX engine: a sum-reduced masked loss plus the L2
registry over canonical parameter paths, the tail batch padded with row 0
under a zero mask, per-batch metrics on the device, one host sync per epoch.
``fit`` copies its data to the device once and gathers each batch there.

Model classes subclass :class:`BaseModel` and implement ``_build_module()``
returning an ``nn.Module`` with signature
``module(batch, training, generator) -> dict`` whose ``pred`` is [B, 1]
(optional ``aux_loss``: a scalar added to the loss; optional ``logs``: named
scalars averaged into the epoch logs).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .callbacks import CallbackList, History
from .features import FeatureSchema, SparseFeat, VarLenSparseFeat
from .metrics import DEVICE_METRICS, HOST_METRICS
from .optimizers import get_optimizer
from .weights import (
    canonical_paths,
    flatten_tree,
    from_jax_weights,
    to_jax_weights,
    unflatten_tree,
)

# embedding_optimizer="auto" picks the lazy row-sparse optimizer for stacked
# tables of at least this many rows (the JAX package's measured crossover,
# xdeepfm_tpu/basemodel.py:47); the port has only the dense one so far.
AUTO_LAZY_MIN_ROWS = 6_000_000
_LAZY_NOT_PORTED = (
    "the lazy row-sparse embedding optimizer is not ported yet "
    "(ROADMAP.md, queue 1, item 11); use embedding_optimizer='dense'"
)


def _loss_fn_single(name):
    """Sum-reduced masked losses (reference ``basemodel.py:463-481`` maps
    strings to torch functionals called with reduction='sum')."""
    if name == "binary_crossentropy":

        def bce(y_pred, y_true, mask):
            p = y_pred.clamp(1e-7, 1 - 1e-7)
            ll = -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))
            return (ll * mask).sum()

        return bce
    if name == "mse":
        return lambda y_pred, y_true, mask: (mask * (y_pred - y_true) ** 2).sum()
    if name == "mae":
        return lambda y_pred, y_true, mask: (mask * (y_pred - y_true).abs()).sum()
    raise NotImplementedError(name)


def resolve_device(device=None) -> torch.device:
    """``None`` means "cuda"; a CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class BaseModel:
    def __init__(
        self,
        linear_feature_columns,
        dnn_feature_columns,
        l2_reg_linear=1e-5,
        l2_reg_embedding=1e-5,
        init_std=1e-4,
        seed=1024,
        task="binary",
        device=None,
        gpus=None,
    ):
        if gpus is not None and len(gpus) > 1:
            raise NotImplementedError("multi-GPU models arrive with a later port slice")
        self.device = resolve_device(device)
        self.linear_feature_columns = tuple(linear_feature_columns)
        self.dnn_feature_columns = tuple(dnn_feature_columns)
        self.schema = FeatureSchema.build(
            list(linear_feature_columns) + list(dnn_feature_columns)
        )
        self.init_std = init_std
        self.seed = seed
        self.task = task

        # (path-substring pattern, l1, l2) over the canonical parameter paths
        # (``basemodel.py:213-219``); recorded now, applied by training.
        self.regularization_weight: List[Tuple[Tuple[str, ...], float, float]] = []
        self.add_regularization_weight(("embedding_dict/",), l2=l2_reg_embedding)
        self.add_regularization_weight(("linear_model/",), l2=l2_reg_linear)

        self.stop_training = False
        self.history = History()
        self.metrics = {}
        self.metrics_names = ["loss"]
        self.optimizer = None
        self.module = None

    def _finalize(self):
        """Build the module on the CPU from the seed, then move it to the
        device.  Called at the end of each subclass ``__init__``."""
        self.module = self._build_module().to(self.device).eval()

    def _build_module(self):
        raise NotImplementedError

    @property
    def embedding_size(self):
        """The one embedding dim of the sparse DNN features
        (``basemodel.py:2078-2093``); raises if they differ."""
        sizes = {f.embedding_dim for f in self.dnn_feature_columns
                 if isinstance(f, (SparseFeat, VarLenSparseFeat))}
        if len(sizes) > 1:
            raise ValueError(
                "embedding_dim of SparseFeat and VarlenSparseFeat must be same in this model!"
            )
        return sizes.pop()

    def add_regularization_weight(self, pattern, l1=0.0, l2=0.0):
        if isinstance(pattern, str):
            pattern = (pattern,)
        self.regularization_weight.append((tuple(pattern), l1, l2))

    # ------------------------------------------------------ regularization

    def _regularization_terms(self):
        """(parameter, l1, l2) per parameter that a registered pattern
        matches, by its canonical path, with the coefficients of every
        matching pattern added (``basemodel.py:247-253``): the linear table
        ``linear_model/embedding_dict/table_d1`` matches both
        ``embedding_dict/`` and ``linear_model/``."""
        paths = canonical_paths(self.module)
        terms = []
        for name, param in self.module.named_parameters():
            l1 = l2 = 0.0
            for pattern, a, b in self.regularization_weight:
                if all(s in paths[name] for s in pattern):
                    l1, l2 = l1 + a, l2 + b
            if l1 > 0 or l2 > 0:
                terms.append((param, l1, l2))
        return terms

    def _regularization_loss(self):
        """sum(l1*|w|) + sum(l2*w^2) over the registered parameters
        (``basemodel.py:221-245``): part of the loss, so its gradient is
        2*l2*w, not the optimizer's weight decay."""
        total = torch.zeros((), device=self.device)
        for param, l1, l2 in self._reg_terms:
            if l1 > 0:
                total = total + l1 * param.abs().sum()
            if l2 > 0:
                total = total + l2 * param.square().sum()
        return total

    # ------------------------------------------------------------- compile

    def compile(self, optimizer, loss=None, metrics=None, lr=None,
                embedding_optimizer="dense", embedding_gradient="auto",
                embedding_layout="auto", embedding_state_dtype="float32"):
        """Optimizer (a name, or a factory of ``torch.optim.Optimizer`` in
        place of an optax transformation), loss name(s) and host metric names
        (``basemodel.py:257-440``).  The embedding-optimizer options are the
        JAX package's; only their dense settings are ported, and any that
        resolves to the lazy row-sparse optimizer raises."""
        if embedding_optimizer not in ("dense", "auto", "lazy"):
            raise ValueError(embedding_optimizer)
        if embedding_gradient not in ("auto", "dense", "split"):
            raise ValueError(embedding_gradient)
        if embedding_layout not in ("auto", "packed", "flat"):
            raise ValueError(embedding_layout)
        if embedding_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(embedding_state_dtype)
        if embedding_optimizer == "auto":
            max_rows = max(
                (p.shape[0] for n, p in self.module.named_parameters() if "table_d" in n),
                default=0,
            )
            lazy = max_rows >= AUTO_LAZY_MIN_ROWS and optimizer in ("adam", "adagrad")
            embedding_optimizer = "lazy" if lazy else "dense"
        if embedding_optimizer == "lazy":
            raise NotImplementedError(_LAZY_NOT_PORTED)
        if embedding_layout == "packed" or embedding_state_dtype == "bfloat16":
            raise ValueError(
                "embedding_layout='packed' and embedding_state_dtype='bfloat16' "
                "need embedding_optimizer='lazy'"
            )
        self.loss_names = list(loss) if isinstance(loss, list) else loss
        self.metrics_names = ["loss"]
        self.metrics = self._get_metrics(metrics)
        self.optimizer = get_optimizer(optimizer, self.module.parameters(), lr)
        self._reg_terms = self._regularization_terms()

    def _get_metrics(self, metrics):
        metrics_ = {}
        for m in metrics or ():
            if m not in HOST_METRICS:
                raise NotImplementedError(m)
            metrics_[m] = HOST_METRICS[m]
            self.metrics_names.append(m)
        return metrics_

    # ----------------------------------------------------------------- fit

    def _train_step(self, xb, y, mask, with_metrics=True):
        """One step on device tensors (``basemodel.py:901-1210``): forward,
        sum-loss + regularisation + aux loss, backward, optimizer update.
        Returns (total loss, {metric or module log: value}) as device
        scalars.  The batch gains ``labels`` and ``sample_mask``, as the JAX
        engine's does (``basemodel.py:904-905``), for modules whose loss needs
        them (the SFG decoder)."""
        xb = dict(xb, labels=y[:, :1] if y.ndim > 1 else y[:, None], sample_mask=mask.reshape(-1))
        out = self.module(xb, training=True, generator=self._dropout_gen)
        pred = out["pred"]
        loss = _loss_fn_single(self.loss_names)(pred.reshape(-1), y.reshape(-1), mask)
        total = loss + self._regularization_loss() + out.get("aux_loss", 0.0)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        mvals = {}
        if with_metrics:
            with torch.no_grad():
                y0 = y.reshape(y.shape[0], -1)[:, 0]
                p0 = pred.detach().reshape(pred.shape[0], -1)[:, 0]
                mvals = {name: DEVICE_METRICS[name](y0, p0, mask) for name in self.metrics}
        # scalars a module publishes (sfg_loss) reach the epoch logs even at
        # verbose=0 (basemodel_sfg.py:366-367)
        for name, value in out.get("logs", {}).items():
            mvals[name] = value.detach()
        return total.detach(), mvals

    def fit(self, x=None, y=None, batch_size=None, epochs=1, verbose=1,
            initial_epoch=0, validation_split=0.0, validation_data=None,
            shuffle=True, callbacks=None, steps_per_dispatch=1):
        """Keras-style training loop (``basemodel.py:1288-1461``).  Returns the
        ``History``.  ``steps_per_dispatch`` is accepted for the JAX engine's
        signature, where it runs K steps as one XLA program; here every step
        is its own Python-loop turn (K steps in one CUDA graph is later
        work), so it changes no result."""
        if self.optimizer is None:
            raise RuntimeError("call compile() before fit()")
        if isinstance(self.loss_names, list):
            raise NotImplementedError("loss lists arrive with the multitask models")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        batch = self._pack_x(x)
        y = np.asarray(y, dtype=np.float32)
        if y.ndim == 1:
            y = y[:, None]
        n = len(y)

        do_validation = False
        if validation_data:
            do_validation = True
            if len(validation_data) not in (2, 3):
                raise ValueError(
                    "When passing a `validation_data` argument, it must contain "
                    "either 2 items (x_val, y_val), or 3 items "
                    "(x_val, y_val, val_sample_weights)"
                )
            val_batch = self._pack_x(validation_data[0])
            val_y = np.asarray(validation_data[1], dtype=np.float32)
        elif validation_split and 0.0 < validation_split < 1.0:
            do_validation = True
            split_at = int(n * (1.0 - validation_split))
            val_batch = {k: v[split_at:] for k, v in batch.items()}
            val_y = y[split_at:]
            batch = {k: v[:split_at] for k, v in batch.items()}
            y = y[:split_at]
            n = split_at
        else:
            val_batch, val_y = None, []

        if batch_size is None:
            batch_size = 256
        steps_per_epoch = (n - 1) // batch_size + 1
        # the training data lives on the device; batches are gathered there
        x_dev = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        y_dev = torch.as_tensor(y, device=self.device)

        callbacks = CallbackList((callbacks or []) + [self.history])
        callbacks.set_model(self)
        callbacks.set_params({
            "batch_size": batch_size, "epochs": epochs,
            "steps": steps_per_epoch, "samples": n, "verbose": verbose,
            "do_validation": do_validation, "metrics": self.metrics_names,
        })
        callbacks.on_train_begin()
        self.stop_training = False
        # dropout masks: one stream per fit, as the JAX engine folds the step
        # number into a key seeded with seed + 1
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)

        print(
            "Train on {0} samples, validate on {1} samples, {2} steps per "
            "epoch".format(n, len(val_y), steps_per_epoch)
        )
        rng = np.random.default_rng(self.seed)
        for epoch in range(initial_epoch, epochs):
            callbacks.on_epoch_begin(epoch)
            start_time = time.time()
            perm = rng.permutation(n) if shuffle else np.arange(n)
            # the tail batch is padded with row 0 under a zero mask
            idx = np.zeros(steps_per_epoch * batch_size, np.int64)
            idx[:n] = perm
            mask = np.zeros(steps_per_epoch * batch_size, np.float32)
            mask[:n] = 1.0
            idx = torch.as_tensor(idx, device=self.device)
            mask = torch.as_tensor(mask, device=self.device)
            totals, mvals = [], []
            for i in range(steps_per_epoch):
                take = idx[i * batch_size : (i + 1) * batch_size]
                total, mv = self._train_step(
                    {k: v.index_select(0, take) for k, v in x_dev.items()},
                    y_dev.index_select(0, take),
                    mask[i * batch_size : (i + 1) * batch_size],
                    with_metrics=verbose > 0,
                )
                totals.append(total)
                mvals.append(mv)
            epoch_logs = self._epoch_logs(totals, mvals, n, steps_per_epoch)
            if do_validation:
                eval_result = self._evaluate_packed(val_batch, val_y, batch_size)
                for name, result in eval_result.items():
                    epoch_logs["val_" + name] = result

            if verbose > 0:
                epoch_time = int(time.time() - start_time)
                print("Epoch {0}/{1}".format(epoch + 1, epochs))
                eval_str = "{0}s - loss: {1: .4f}".format(epoch_time, epoch_logs["loss"])
                for name in self.metrics:
                    eval_str += " - " + name + ": {0: .4f}".format(epoch_logs[name])
                if do_validation:
                    for name in self.metrics:
                        eval_str += " - val_" + name + ": {0: .4f}".format(
                            epoch_logs["val_" + name]
                        )
                print(eval_str)
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        return self.history

    @staticmethod
    def _prefetch_iter(it, depth=3):
        """Pull ``it`` in a background thread (queue depth bounded) so that
        host-side batch production (file parse, preprocessing) overlaps the
        device steps.  The native parser (ctypes) and numpy release the GIL,
        so a plain thread captures most of the overlap.  The thread runs no
        CUDA work: the copies and launches stay with the consumer.  An
        exception raised by ``it`` is raised in the consumer; a consumer that
        stops early stops the thread, which has exited when the generator
        closes."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        end = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return
                put(end)
            except BaseException as e:  # re-raised in the consumer below
                put(e)

        t = threading.Thread(target=worker, name="fit_stream-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def fit_stream(self, generator, epochs=1, verbose=1, initial_epoch=0, validation_data=None,
                   callbacks=None, steps_per_dispatch=1, steps_per_epoch=None, prefetch=3):
        """Out-of-core training from a batch stream (``basemodel.py:1507-1711``).

        ``generator`` yields ``(x, y)`` batches (``x`` a feature dict, ``y``
        labels) of one batch size; the final batch may be shorter, and is
        padded and masked like ``fit``'s tail.  It is a callable
        ``epoch -> iterable`` (a fresh stream each epoch) or a re-iterable; a
        one-shot iterator supports ``epochs=1`` only.  With ``prefetch`` > 0 a
        thread reads up to that many batches ahead (:meth:`_prefetch_iter`).
        Epoch logs, callbacks, the sum-loss normalisation and the train
        metrics follow :meth:`fit`.  ``steps_per_epoch`` caps each epoch, the
        read-ahead included (the source is consumed exactly that many times);
        by default an epoch is one pass of the stream.  ``steps_per_dispatch``
        changes no result, as in :meth:`fit`."""
        if self.optimizer is None:
            raise RuntimeError("call compile() before fit_stream()")
        if isinstance(self.loss_names, list):
            raise NotImplementedError("loss lists arrive with the multitask models")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        do_validation = bool(validation_data)
        if do_validation:
            val_batch = self._pack_x(validation_data[0])
            val_y = np.asarray(validation_data[1], dtype=np.float32)

        callbacks = CallbackList((callbacks or []) + [self.history])
        callbacks.set_model(self)
        callbacks.set_params({
            "epochs": epochs, "verbose": verbose,
            # keras convention: steps present but None when the stream's
            # length is unknown up front
            "steps": steps_per_epoch,
            "do_validation": do_validation, "metrics": self.metrics_names,
        })
        callbacks.on_train_begin()
        self.stop_training = False
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        if verbose > 0:
            print("Train on stream, validate on {0} samples".format(
                len(val_y) if do_validation else 0))

        batch_size = None
        for epoch in range(initial_epoch, epochs):
            callbacks.on_epoch_begin(epoch)
            start_time = time.time()
            n_seen = 0
            totals, mvals = [], []
            stream = generator(epoch) if callable(generator) else generator
            if prefetch:
                src = iter(stream)
                if steps_per_epoch:
                    src = itertools.islice(src, steps_per_epoch)
                stream = self._prefetch_iter(src, depth=prefetch)
            try:
                for x, yb in stream:
                    xb = self._pack_x(x)
                    yb = np.asarray(yb, dtype=np.float32)
                    if yb.ndim == 1:
                        yb = yb[:, None]
                    bs = len(yb)
                    if batch_size is None:
                        batch_size = bs
                    if bs > batch_size:
                        raise ValueError(f"stream batch of {bs} rows exceeds the stream's "
                                         f"batch size {batch_size}")
                    n_seen += bs
                    mask = np.ones((batch_size,), np.float32)
                    if bs < batch_size:
                        pad = batch_size - bs
                        mask[bs:] = 0.0
                        xb = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                              for k, v in xb.items()}
                        yb = np.concatenate([yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
                    total, mv = self._train_step(
                        {k: torch.as_tensor(v, device=self.device) for k, v in xb.items()},
                        torch.as_tensor(yb, device=self.device),
                        torch.as_tensor(mask, device=self.device),
                        with_metrics=verbose > 0,
                    )
                    totals.append(total)
                    mvals.append(mv)
                    if steps_per_epoch and len(totals) >= steps_per_epoch:
                        break
            finally:
                if prefetch:
                    stream.close()  # stops the prefetch thread, also on an error
            if totals:
                epoch_logs = self._epoch_logs(totals, mvals, n_seen, len(totals))
            else:
                epoch_logs = {"loss": float("nan")}
            if do_validation:
                eval_result = self._evaluate_packed(val_batch, val_y, batch_size or 256)
                for name, result in eval_result.items():
                    epoch_logs["val_" + name] = result

            if verbose > 0:
                epoch_time = int(time.time() - start_time)
                print("Epoch {0}/{1}".format(epoch + 1, epochs))
                eval_str = "{0}s - {1} samples - loss: {2: .4f}".format(
                    epoch_time, n_seen, epoch_logs["loss"])
                for name in self.metrics:
                    eval_str += " - " + name + ": {0: .4f}".format(epoch_logs[name])
                if do_validation:
                    for name in self.metrics:
                        eval_str += " - val_" + name + ": {0: .4f}".format(
                            epoch_logs["val_" + name])
                print(eval_str)
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        return self.history

    @staticmethod
    def _epoch_logs(totals, mvals, n, steps_per_epoch) -> Dict[str, float]:
        """The epoch's loss (sum of step totals over n) and train metrics and
        module logs (mean over steps), read from the device in one transfer."""
        names = list(mvals[0]) if mvals else []
        values = torch.stack(totals + [mv[k] for mv in mvals for k in names]).cpu().numpy()
        logs = {"loss": float(np.sum(values[: len(totals)].astype(np.float64))) / n}
        per_step = values[len(totals) :].reshape(len(mvals), len(names)).astype(np.float64)
        for j, name in enumerate(names):
            logs[name] = float(np.sum(per_step[:, j]) / steps_per_epoch)
        return logs

    # ------------------------------------------------------ evaluate/predict

    def _pack_x(self, x):
        if isinstance(x, dict):
            return self.schema.pack(x)
        if isinstance(x, (list, tuple)):
            names = self.schema.feature_names()
            return self.schema.pack(dict(zip(names, x)))
        raise TypeError("x must be a dict or list of arrays")

    def _dummy_batch(self, n=2):
        batch = {}
        if self.schema.sparse:
            batch["sparse"] = np.zeros((n, self.schema.n_sparse), np.int32)
        if self.schema.dense:
            batch["dense"] = np.zeros((n, self.schema.dense_dim), np.float32)
        for f in self.schema.varlen:
            batch["vl_" + f.name] = np.zeros((n, f.maxlen), np.int32)
            if f.length_name is not None:
                batch["len_" + f.length_name] = np.ones((n, 1), np.int32)
        return batch

    def _predict_step(self, batch):
        """Typed numpy batch -> predictions [B, 1] on the device."""
        xb = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        with torch.inference_mode():
            return self.module(xb, training=False)["pred"]

    def evaluate(self, x, y, batch_size=256):
        return self._evaluate_packed(self._pack_x(x), y, batch_size)

    def _evaluate_packed(self, batch, y, batch_size=256):
        pred = self._predict_packed(batch, batch_size)
        return {
            name: fn(np.asarray(y).reshape(pred.shape), pred)
            for name, fn in self.metrics.items()
        }

    def predict(self, x, batch_size=256):
        return self._predict_packed(self._pack_x(x), batch_size)

    def _predict_packed(self, batch, batch_size=256):
        """Whole batches only: the tail is padded by repeating the last row
        and sliced off again; float64 out (``basemodel.py:1726-1761``)."""
        n = len(next(iter(batch.values())))
        n_batches = (n - 1) // batch_size + 1 if n else 0
        n_pad = n_batches * batch_size - n
        if n_pad:
            batch = {
                k: np.concatenate([v, np.repeat(v[-1:], n_pad, axis=0)])
                for k, v in batch.items()
            }
        preds = [
            self._predict_step(
                {k: v[i * batch_size : (i + 1) * batch_size] for k, v in batch.items()}
            )
            for i in range(n_batches)
        ]
        if not preds:
            return np.zeros((0, 1), dtype="float64")
        return torch.cat(preds)[:n].cpu().numpy().astype("float64")

    # --------------------------------------------------------- weights I/O

    def get_weights(self):
        """The canonical tree of the JAX package's ``get_weights``
        (``basemodel.py:1765-1773``), as numpy."""
        return to_jax_weights(self.module)

    def set_weights(self, weights):
        """Load a canonical tree; names and shapes must match exactly."""
        self.module.load_state_dict(from_jax_weights(weights), strict=True)

    def save_weights(self, path):
        """``.npz`` keyed by canonical path (``params/cin/conv_w_0``...)."""
        flat = dict(flatten_tree(self.get_weights()["params"], "params"))
        with open(path, "wb") as f:
            np.savez(f, **flat)

    def load_weights(self, path):
        """Reads ``save_weights``' file, or the weights of
        ``save_checkpoint``'s."""
        with np.load(path, allow_pickle=False) as data:
            tree = unflatten_tree({k: data[k] for k in data.files if k.startswith("params/")})
        self.set_weights({"params": tree["params"], "batch_stats": {}})

    def _parameter_paths(self):
        """(canonical path by parameter id, parameter by canonical path)."""
        paths = canonical_paths(self.module)
        named = dict(self.module.named_parameters())
        return {id(p): paths[n] for n, p in named.items()}, {paths[n]: p for n, p in named.items()}

    def save_checkpoint(self, path, epoch=0):
        """The full training checkpoint (``basemodel.py:1860-1877``) in the
        port's own format, one ``.npz``: the canonical params
        (``params/...``, as ``save_weights``), the optimizer state keyed by
        canonical parameter path (``opt_state/<path>/<slot>``, e.g.
        ``opt_state/dnn/linear_0/kernel/exp_avg``; each slot in the
        parameter's own layout) and ``epoch``.  The JAX package's msgpack
        checkpoints are not read (ROADMAP.md, D1)."""
        if self.optimizer is None:
            raise RuntimeError("compile() before save_checkpoint()")
        flat = dict(flatten_tree(self.get_weights()["params"], "params"))
        path_of, _ = self._parameter_paths()
        for param, state in self.optimizer.state.items():
            for slot, value in state.items():
                if value is not None:
                    value = value.detach().cpu() if torch.is_tensor(value) else value
                    flat[f"opt_state/{path_of[id(param)]}/{slot}"] = np.asarray(value)
        flat["epoch"] = np.asarray(epoch, np.int64)
        with open(path, "wb") as f:
            np.savez(f, **flat)

    def load_checkpoint(self, path) -> int:
        """Restore ``save_checkpoint``'s params and optimizer state; returns
        the epoch, for ``fit(initial_epoch=...)``."""
        if self.optimizer is None:
            raise RuntimeError("compile() before load_checkpoint()")
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
        params = {k: v for k, v in flat.items() if k.startswith("params/")}
        self.set_weights({"params": unflatten_tree(params)["params"], "batch_stats": {}})
        _, param_at = self._parameter_paths()
        index = {id(p): i for i, p in enumerate(
            p for group in self.optimizer.param_groups for p in group["params"])}
        state = {}
        for key, value in flat.items():
            if key.startswith("opt_state/"):
                where, slot = key[len("opt_state/"):].rsplit("/", 1)
                state.setdefault(index[id(param_at[where])], {})[slot] = torch.from_numpy(value)
        sd = self.optimizer.state_dict()
        self.optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
        return int(flat["epoch"])
