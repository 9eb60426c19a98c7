"""Optimizers, usable both densely and row-wise on embedding rows (port of
`herald_tpu/optim/optimizers.py`).

Plain functions on tensors, not `torch.optim`: `apply_rows` updates a
gathered set of rows [U, D] with their gathered slot states, and the
engine owns the gather and the write-back, as in the JAX package.

Dtypes follow JAX's promotion step by step:
- A Python float is weakly typed in JAX: next to a bf16 slot it becomes a
  bf16 constant (`0.9 * m` multiplies by bf16(0.9) = 0.8984375). torch
  applies a Python scalar at full precision, so every constant goes
  through `_weak`, which rounds it to the tensor's dtype first.
- The learning rate from a schedule is a 0-d float32 *array*, which
  promotes in JAX (`lr * bf16_grads` is float32, and so is `rows - upd`);
  torch does not promote a dimensioned tensor by a 0-d one, so every
  product with `lr` or with the 0-d step `t` widens explicitly (`_scale`,
  `_promote`). With a bf16 table the row update is therefore
  `bf16(f32(row) - f32 upd)`, as in JAX, while the slots stay bf16.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch


@functools.lru_cache(maxsize=256)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return torch.tensor(c, dtype=dtype).item()


def _weak(c: float, x: torch.Tensor) -> float:
    """The Python constant `c` as JAX applies it to `x`: rounded to x's
    dtype (exact for f32, where torch rounds the same way)."""
    return _rounded(float(c), x.dtype)


def _promote(x: torch.Tensor, scalar: torch.Tensor) -> torch.Tensor:
    """`x` widened to JAX's result dtype of `x op scalar` for a 0-d
    array (bf16 with f32 -> f32)."""
    return x.to(torch.promote_types(x.dtype, scalar.dtype))


def _norm(x: torch.Tensor, dim=None) -> torch.Tensor:
    """`jnp.linalg.norm` as JAX lowers it: squares in x's dtype, an f32
    sum rounded back to x's dtype, then the root."""
    sq = (x * x).to(torch.float32)
    total = sq.sum() if dim is None else sq.sum(dim, keepdim=True)
    return torch.sqrt(total.to(x.dtype))


def _scale(lr, x: torch.Tensor) -> torch.Tensor:
    """`lr * x` with JAX's dtype: a 0-d tensor promotes, a Python float
    is weak."""
    if isinstance(lr, torch.Tensor):
        return lr * _promote(x, lr)
    return _weak(lr, x) * x


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    lr: float = 0.01
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7
    weight_decay: float = 0.0

    # ------------------------------------------------------------------
    @property
    def slot_names(self) -> Tuple[str, ...]:
        return {
            "sgd": (),
            "momentum": ("velocity",),
            "nesterov": ("velocity",),
            "adagrad": ("accum",),
            "adam": ("m", "v"),
            "adamw": ("m", "v"),
            "lamb": ("m", "v"),
        }[self.name]

    def init_slots(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {s: torch.zeros_like(param) for s in self.slot_names}

    def _moments(self, g, slots, step):
        """Adam moments and the bias-corrected direction (f32 where JAX
        divides by the f32 correction)."""
        m = (_weak(self.beta1, slots["m"]) * slots["m"]
             + _weak(1 - self.beta1, g) * g)
        v = (_weak(self.beta2, slots["v"]) * slots["v"]
             + _weak(1 - self.beta2, g) * g * g)
        t = step.to(torch.float32)
        mhat = _promote(m, t) / (1 - self.beta1 ** t)
        vhat = _promote(v, t) / (1 - self.beta2 ** t)
        return m, v, mhat / (torch.sqrt(vhat) + _weak(self.eps, vhat))

    # ------------------------------------------------------------------
    def apply_rows(
        self,
        rows: torch.Tensor,              # [U, D] current values
        grads: torch.Tensor,             # [U, D] summed grads for these rows
        slots: Dict[str, torch.Tensor],  # each [U, D]
        step: torch.Tensor,              # 0-d int, 1-based
        lr=None,                         # float or 0-d f32 tensor
        counts: Optional[torch.Tensor] = None,  # [U] update counts
        mask: Optional[torch.Tensor] = None,    # [U] bool, False = padding
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Return (new_rows, new_slots). Padding rows pass through
        unchanged."""
        upd, new_slots = self._update(rows, grads, slots, step, lr, counts,
                                      mask)
        return rows - upd, new_slots

    def _update(self, rows, grads, slots, step, lr=None, counts=None,
                mask=None):
        """(upd, new_slots) of `apply_rows`: the new rows are rows - upd."""
        lr = self.lr if lr is None else lr
        g = grads
        if counts is not None:
            # ApplyCache semantics (`optimizer.h`): scale by per-row counts
            g = g / torch.clamp(counts, min=1).to(g.dtype)[:, None]
        if self.weight_decay and self.name not in ("adamw", "lamb"):
            # adamw/lamb decay is decoupled (added to the direction below)
            g = g + _weak(self.weight_decay, rows) * rows

        new_slots = dict(slots)
        if self.name == "sgd":
            upd = _scale(lr, g)
        elif self.name in ("momentum", "nesterov"):
            vel = (_weak(self.momentum, slots["velocity"])
                   * slots["velocity"] + g)
            if self.name == "nesterov":
                upd = _scale(lr, g + _weak(self.momentum, vel) * vel)
            else:
                upd = _scale(lr, vel)
            new_slots["velocity"] = vel
        elif self.name == "adagrad":
            acc = slots["accum"] + g * g
            upd = _scale(lr, g) / (torch.sqrt(acc) + _weak(self.eps, acc))
            new_slots["accum"] = acc
        elif self.name in ("adam", "adamw", "lamb"):
            m, v, direction = self._moments(g, slots, step)
            decay = _weak(self.weight_decay, rows) * rows
            if self.name == "adamw":
                direction = direction + decay
            if self.name == "lamb":
                direction = direction + decay
                # row-wise trust ratio (per embedding row)
                wn = _norm(rows, -1)
                dn = _norm(direction, -1)
                trust = torch.where((wn > 0) & (dn > 0), wn / (dn + 1e-12),
                                    1.0)
                direction = trust * direction
            upd = _scale(lr, direction)
            new_slots["m"], new_slots["v"] = m, v
        else:
            raise ValueError(f"unknown optimizer {self.name}")

        if mask is not None:
            fmask = mask.to(rows.dtype)
            while fmask.dim() < rows.dim():
                fmask = fmask[..., None]
            upd = upd * fmask
            for k in new_slots:
                new_slots[k] = torch.where(fmask > 0, new_slots[k], slots[k])
        return upd, new_slots

    # ------------------------------------------------------------------
    def apply_dense(self, params, grads, slots, step, lr=None,
                    in_place: bool = False):
        """Dict-wide dense update: params and grads are {name: tensor},
        slots {name: {slot: tensor}}. A parameter without slots may be
        missing from `slots` or map to an empty dict (JAX's form under
        SGD, `{"W1": {}, ...}`); the result always has JAX's form. With
        `in_place` each param is updated in its own tensor (the same bits
        as the new tensor otherwise returned); the slots are new tensors
        either way."""
        new_p, new_s = {}, {}
        for k, p in params.items():
            s = slots.get(k, {})
            if self.name == "lamb":
                # full-tensor trust ratio for dense params
                upd, new_s[k] = self._lamb_update(p, grads[k], s, step, lr)
            else:
                upd, new_s[k] = self._update(p, grads[k], s, step, lr)
            new_p[k] = p.sub_(upd) if in_place else p - upd
        return new_p, new_s

    def _lamb_dense(self, p, g, slots, step, lr=None):
        upd, new_slots = self._lamb_update(p, g, slots, step, lr)
        return p - upd, new_slots

    def _lamb_update(self, p, g, slots, step, lr=None):
        """(upd, new slots) of LAMB on a whole dense tensor."""
        lr = self.lr if lr is None else lr
        m, v, direction = self._moments(g, slots, step)
        direction = direction + _weak(self.weight_decay, p) * p
        wn = _norm(p)
        dn = _norm(direction)
        trust = torch.where((wn > 0) & (dn > 0), wn / (dn + 1e-12), 1.0)
        # JAX's order, (lr * trust) * direction; `direction` is f32
        return _scale(lr, trust) * direction, {"m": m, "v": v}


OPTIMIZERS = ("sgd", "momentum", "nesterov", "adagrad", "adam", "adamw",
              "lamb")


def get_optimizer(name: str, lr: float = 0.01, **kw) -> Optimizer:
    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; have {OPTIMIZERS}")
    return Optimizer(name=name, lr=lr, **kw)
