"""Training callbacks (port of ``xdeepfm_tpu/callbacks.py``).

The reference re-exports keras's EarlyStopping/History and patches
ModelCheckpoint (``deepctr/callbacks.py``); the JAX package implements the
protocol natively and so does this copy: ``on_train_begin / on_epoch_begin /
on_epoch_end(logs) / on_train_end``, ``model.stop_training`` propagation,
monitor/mode/min_delta/patience behaviour.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = None  # filled by CallbackList.set_params from fit()

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        self.model = model
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        self.params = params
        for c in self.callbacks:
            c.set_params(params)

    def on_train_begin(self, logs=None):
        for c in self.callbacks:
            c.on_train_begin(logs)

    def on_train_end(self, logs=None):
        for c in self.callbacks:
            c.on_train_end(logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)


class History(Callback):
    """Records epoch logs; returned by fit() (keras-compatible surface)."""

    def on_train_begin(self, logs=None):
        self.epoch = []
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        self.epoch.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


def _monitor_op(mode: str, monitor: str):
    if mode not in ("auto", "min", "max"):
        warnings.warn("mode %s is unknown, fallback to auto" % mode)
        mode = "auto"
    if mode == "min":
        return np.less
    if mode == "max":
        return np.greater
    if "acc" in monitor or "auc" in monitor:
        return np.greater
    return np.less


class EarlyStopping(Callback):
    """keras-semantics early stopping (monitor/min_delta/patience/mode/
    baseline/restore_best_weights)."""

    def __init__(
        self,
        monitor="val_loss",
        min_delta=0,
        patience=0,
        verbose=0,
        mode="auto",
        baseline=None,
        restore_best_weights=False,
    ):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.restore_best_weights = restore_best_weights
        self.monitor_op = _monitor_op(mode, monitor)
        # an improvement must beat the best by min_delta in the monitored
        # direction
        self.min_delta = abs(min_delta) * (1 if self.monitor_op == np.greater else -1)

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped_epoch = 0
        self.best = (
            self.baseline
            if self.baseline is not None
            else (-np.inf if self.monitor_op == np.greater else np.inf)
        )
        self.best_state = None

    def get_monitor_value(self, logs):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            warnings.warn(
                "Early stopping conditioned on metric `%s` which is not "
                "available. Available metrics are: %s"
                % (self.monitor, ",".join(logs.keys()))
            )
        return value

    def on_epoch_end(self, epoch, logs=None):
        current = self.get_monitor_value(logs)
        if current is None:
            return
        if self.monitor_op(current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
            if self.restore_best_weights:
                self.best_state = self.model.get_weights()
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True
                if self.restore_best_weights and self.best_state is not None:
                    if self.verbose > 0:
                        print("Restoring model weights from the end of the best epoch.")
                    self.model.set_weights(self.best_state)

    def on_train_end(self, logs=None):
        if self.stopped_epoch > 0 and self.verbose > 0:
            print("Epoch %05d: early stopping" % (self.stopped_epoch + 1))


class ModelCheckpoint(Callback):
    """Save the model on monitored-metric improvement (reference:
    ``deepctr/callbacks.py:9-73``).  ``save_weights_only=False`` writes the
    full training checkpoint through ``model.save_checkpoint`` where the
    model has one, else its weights (``save_weights``)."""

    def __init__(
        self,
        filepath,
        monitor="val_loss",
        verbose=0,
        save_best_only=False,
        save_weights_only=False,
        mode="auto",
        period=1,
    ):
        super().__init__()
        self.filepath = filepath
        self.monitor = monitor
        self.verbose = verbose
        self.save_best_only = save_best_only
        self.save_weights_only = save_weights_only
        self.period = period
        self.epochs_since_last_save = 0
        self.monitor_op = _monitor_op(mode, monitor)
        self.best = -np.inf if self.monitor_op == np.greater else np.inf

    def _save(self, filepath):
        if self.save_weights_only or not hasattr(self.model, "save_checkpoint"):
            self.model.save_weights(filepath)
        else:
            self.model.save_checkpoint(filepath)

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        self.epochs_since_last_save += 1
        if self.epochs_since_last_save < self.period:
            return
        self.epochs_since_last_save = 0
        filepath = self.filepath.format(epoch=epoch + 1, **logs)
        if not self.save_best_only:
            if self.verbose > 0:
                print("\nEpoch %05d: saving model to %s" % (epoch + 1, filepath))
            self._save(filepath)
            return
        current = logs.get(self.monitor)
        if current is None:
            warnings.warn(
                "Can save best model only with %s available, skipping." % self.monitor
            )
            return
        if self.monitor_op(current, self.best):
            if self.verbose > 0:
                print(
                    "\nEpoch %05d: %s improved from %0.5f to %0.5f, saving model to %s"
                    % (epoch + 1, self.monitor, self.best, current, filepath)
                )
            self.best = current
            self._save(filepath)
        elif self.verbose > 0:
            print(
                "\nEpoch %05d: %s did not improve from %0.5f"
                % (epoch + 1, self.monitor, self.best)
            )


class LogWriter(Callback):
    """Scalar logger: JSONL always; TensorBoard events where
    ``torch.utils.tensorboard`` imports (the JAX package's ``LogWriter``,
    ``xdeepfm_tpu/callbacks.py:247``; stand-in for the CLIs' inline
    TensorBoardCallback, ``xdftrain.py:31-97``).
    """

    def __init__(self, log_dir, tensorboard=True):
        super().__init__()
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)

    def scalar(self, tag, value, step):
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def text(self, tag, value, step=0):
        if self._tb is not None:
            self._tb.add_text(tag, value, step)

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        for k, v in logs.items():
            section = "Validation" if k.startswith("val_") else "Training"
            name = k[4:] if k.startswith("val_") else k
            self.scalar(f"{section}/{name}", v, epoch)

    def on_train_end(self, logs=None):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __del__(self):  # fd-leak guard for writers never explicitly closed
        try:
            self.close()
        except Exception:
            pass
