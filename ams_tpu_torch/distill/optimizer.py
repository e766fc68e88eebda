"""TF1-semantics Adam, in PyTorch.

Counterpart of ``ams_tpu/distill/optimizer.py``.  The reference trains
with ``tf.train.AdamOptimizer``, whose update puts epsilon outside the
bias fix:

    lr_t  = lr * sqrt(1 - b2^t) / (1 - b1^t)        (f32, from an int step)
    m_t   = b1*m + (1-b1)*g ;  v_t = b2*v + (1-b2)*g^2
    p_t   = p - lr_t * m_t / (sqrt(v_t) + eps)

The step is always unmasked: the round applies the mask with
``torch.where`` on the stepped params, so slots advance for every
parameter, as the reference's ``train_coord`` does.  The arithmetic runs
as ``torch._foreach_*`` ops over all keys, a few launches per step on the
card instead of several per tensor; each op rounds as the per-tensor
expression above does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ADAM_BETA1 = 0.9
ADAM_BETA2 = 0.999
ADAM_EPS = 1e-8


class AdamState(NamedTuple):
    step: torch.Tensor         # 0-dim int32, on the parameters' device;
    #                            (V,) for V videos' stacked states
    m: dict                    # first moments over the trainable params
    v: dict                    # second moments


def adam_init(trainable_params: dict) -> AdamState:
    some = next(iter(trainable_params.values()))
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        m={k: torch.zeros_like(v) for k, v in trainable_params.items()},
        v={k: torch.zeros_like(v) for k, v in trainable_params.items()})


@torch.no_grad()
def adam_apply(params: dict, grads: dict, state: AdamState, lr):
    """One Adam step over the keys of ``grads``.  Returns (new_params,
    new_state); the inputs are not modified.  A stacked state (a (V,)
    step, ``parallel.stack_videos``) steps V videos' stacked parameters
    at once, each video at its own step count: the same numbers as V
    calls."""
    keys = list(grads)
    t = state.step + 1
    tf_ = t.to(torch.float32)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=tf_.device)
    lr_t = lr * torch.sqrt(1.0 - ADAM_BETA2 ** tf_) / (1.0 - ADAM_BETA1 ** tf_)
    if lr_t.dim():
        # one rate per video, over each parameter's trailing dimensions
        lr_t = [lr_t.view(-1, *(1,) * (grads[k].dim() - 1)) for k in keys]

    g = [grads[k].float() for k in keys]
    m = torch._foreach_add(torch._foreach_mul([state.m[k] for k in keys],
                                              ADAM_BETA1),
                           torch._foreach_mul(g, 1.0 - ADAM_BETA1))
    v = torch._foreach_add(torch._foreach_mul([state.v[k] for k in keys],
                                              ADAM_BETA2),
                           torch._foreach_mul(torch._foreach_mul(g, g),
                                              1.0 - ADAM_BETA2))
    denom = torch._foreach_add(torch._foreach_sqrt(v), ADAM_EPS)
    upd = torch._foreach_div(torch._foreach_mul(m, lr_t), denom)
    stepped = torch._foreach_sub([params[k] for k in keys], upd)

    new_params = dict(params)
    new_params.update(zip(keys, stepped))
    new_m = dict(state.m)
    new_m.update(zip(keys, m))
    new_v = dict(state.v)
    new_v.update(zip(keys, v))
    return new_params, AdamState(step=t, m=new_m, v=new_v)
