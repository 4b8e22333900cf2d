"""Event/callback bus (reference utils/callbacks.py:7-61): named hooks fired
through the train/val lifecycle; loggers register handlers. A copy of
``yolov5_tpu/utils/callbacks.py``."""

from __future__ import annotations

HOOKS = [
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start", "on_val_batch_start", "on_val_image_end",
    "on_val_batch_end", "on_val_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end",
    "on_params_update", "teardown",
]


class Callbacks:
    def __init__(self):
        self._callbacks = {h: [] for h in HOOKS}
        self.stop_training = False

    def register_action(self, hook, name="", callback=None):
        assert hook in self._callbacks, f"unknown hook {hook}"
        assert callable(callback)
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook=None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook, *args, **kwargs):
        assert hook in self._callbacks, f"unknown hook {hook}"
        for action in self._callbacks[hook]:
            action["callback"](*args, **kwargs)
