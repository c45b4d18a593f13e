"""Numeric constants of the models, made once per (device, dtype)."""

import numpy as np
import torch


class Const:
    """A numpy constant as a tensor on the device and in the dtype of the
    tensor it meets, made once per (device, dtype): a copy from host
    memory to the card waits for the card's queue."""

    def __init__(self, value):
        self.value = np.asarray(value, dtype=float)
        self._made = {}

    def like(self, x):
        key = (x.device, x.dtype)
        if key not in self._made:
            # made outside the torch.func transforms the call may sit in: a
            # tensor made inside one is wrapped at its level and must not
            # outlive it
            with torch._C._DisableFuncTorch():
                self._made[key] = torch.as_tensor(self.value, dtype=x.dtype, device=x.device)
        return self._made[key]
