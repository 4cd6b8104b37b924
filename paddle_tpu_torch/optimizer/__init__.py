"""Optimizers: Adam and AdamW (port of ``paddle_tpu/optimizer/__init__.py``).

The reference's dual API, on dicts of tensors keyed by parameter name:

* **Functional**: ``state = opt.init_state(params)``;
  ``new_params, new_state = opt.update(grads, state, params)``. With
  ``multi_precision`` (the only mode ported) non-fp32 parameters get fp32
  ``master`` copies, the moments are fp32, and the new parameters are the
  masters cast to the parameter dtype (reference :102-113, :189).
* **Eager veneer**: ``opt.apply_gradients(named_grads, model=...)``, and the
  PyTorch idiom ``opt.step()`` / ``opt.clear_grad()`` over the ``.grad`` of
  the ``parameters=`` given at construction; both write the new values into
  the parameters in place.

``update`` is pure, as the reference's is: it leaves the state and the
parameters it is given untouched. ``update_`` is its in-place form, which
the eager veneer uses: it advances the state's fp32 slots (moments and
masters) where they lie — at GPT-2 345M that saves 4.3 GB of copies per
step. The arithmetic runs as PyTorch's multi-tensor (``_foreach``) ops, in
the order of the reference's (an XLA fusion there, not a Pallas kernel).

Not ported yet (ROADMAP Queue A item 5): LR schedulers, gradient clipping,
``multi_precision=False``, L1 decay, SGD / Momentum / Lamb and the other
siblings; they raise ``NotImplementedError``.
"""

from typing import Dict

import numpy as np
import torch

_TODO = "(ROADMAP Queue A item 5)"


class Optimizer:
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning-rate schedulers are not ported yet {_TODO}; pass "
                "a float")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip is not ported yet {_TODO}")
        if not multi_precision:
            raise NotImplementedError(
                f"multi_precision=False is not ported yet {_TODO}")
        if not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                f"regularizer objects are not ported yet {_TODO}; pass a "
                "float weight_decay")
        self._lr = float(learning_rate)
        self._parameters = list(parameters) if parameters is not None else None
        self.weight_decay = float(weight_decay)
        self.apply_decay_param_fun = apply_decay_param_fun
        self._eager_state = None

    # -- functional API ------------------------------------------------------

    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict:
        slots = self._init_slots(params)
        masters = {k: p.detach().float() for k, p in params.items()
                   if p.dtype != torch.float32}
        if masters:
            slots["master"] = masters
        slots["step"] = 0
        return slots

    def _init_slots(self, params):
        raise NotImplementedError

    def update(self, grads, state, params, step=None):
        """(new_params, new_state); `state` and `params` are not touched."""
        fresh = {k: {n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v for k, v in state.items()}
        return self.update_(grads, fresh, params, step)

    def update_(self, grads, state, params, step=None):
        """update() that advances the moments and masters of `state` in
        place and returns `state` itself as the new state, with its step
        advanced; `params` are not touched."""
        step_ = state["step"] if step is None else step
        masters = state.get("master", {})
        keys = list(params)
        work = [masters[k] if k in masters else params[k].detach()
                for k in keys]
        gf = [grads[k].detach().float() for k in keys]
        delta = self._apply(keys, gf, work, state, step_)
        on_master = [i for i, k in enumerate(keys) if k in masters]
        plain = [i for i, k in enumerate(keys) if k not in masters]
        lr = self._lr
        if on_master:
            torch._foreach_add_([work[i] for i in on_master],
                                [delta[i] for i in on_master], alpha=-lr)
        new_plain = torch._foreach_add([work[i] for i in plain],
                                       [delta[i] for i in plain], alpha=-lr) \
            if plain else []
        new_params = {keys[i]: masters[keys[i]].to(params[keys[i]].dtype)
                      for i in on_master}
        new_params.update({keys[i]: t for i, t in zip(plain, new_plain)})
        state["step"] = step_ + 1
        return {k: new_params[k] for k in keys}, state

    def _apply(self, keys, grads, work, state, step):
        """Advance the slots in place; return the per-key step direction
        (the update is work − lr · direction)."""
        raise NotImplementedError

    def _decay_mask(self, keys):
        if self.apply_decay_param_fun is None:
            return [True] * len(keys)
        return [bool(self.apply_decay_param_fun(k)) for k in keys]

    # -- eager veneer --------------------------------------------------------

    def _named_params(self, model=None):
        if model is not None:
            return model.trainable_state()
        if self._parameters is None:
            raise ValueError("pass parameters= at construction or model= here")
        return {str(i): p for i, p in enumerate(self._parameters)
                if p.requires_grad}

    def apply_gradients(self, named_grads, model=None):
        """Write the updated values into the parameters (of `model`, or
        those given at construction, keyed by position) in place."""
        named = self._named_params(model)
        values = {k: p.detach() for k, p in named.items()}
        grads = {k: named_grads[k] for k in values}
        if self._eager_state is None:
            self._eager_state = self.init_state(values)
        new, self._eager_state = self.update_(grads, self._eager_state,
                                                  values)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new[k])

    def step(self):
        """One update from the ``.grad`` of the parameters given at
        construction (PyTorch idiom)."""
        named = self._named_params()
        missing = [k for k, p in named.items() if p.grad is None]
        if missing:
            raise ValueError(f"step(): parameters {missing} have no .grad; "
                             "run backward first")
        self.apply_gradients({k: p.grad for k, p in named.items()})

    def clear_grad(self):
        for p in self._parameters or ():
            p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, apply_decay_param_fun)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slots(self, params):
        zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in params.items()}
        return {"moment1": zeros(), "moment2": zeros()}

    def _apply(self, keys, grads, work, state, step):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        # bias corrections in fp32, as the reference computes them
        t = np.float32(step + 1)
        bias1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bias2 = float(np.float32(1.0) - np.float32(b2) ** t)
        wd = self.weight_decay
        decay = [i for i, on in enumerate(self._decay_mask(keys)) if on]
        if wd and decay and not self._decoupled_wd:   # coupled L2 on grads
            grads = list(grads)
            added = torch._foreach_add([grads[i] for i in decay],
                                       [work[i] for i in decay], alpha=wd)
            for i, g in zip(decay, added):
                grads[i] = g
        m1 = [state["moment1"][k] for k in keys]
        m2 = [state["moment2"][k] for k in keys]
        torch._foreach_mul_(m1, b1)
        torch._foreach_add_(m1, grads, alpha=1 - b1)
        torch._foreach_mul_(m2, b2)
        torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)
        denom = torch._foreach_div(m2, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        direction = torch._foreach_div(m1, bias1)
        torch._foreach_div_(direction, denom)
        if wd and decay and self._decoupled_wd:       # decoupled: + wd·p
            torch._foreach_add_([direction[i] for i in decay],
                                [work[i] for i in decay], alpha=wd)
        return direction


class AdamW(Adam):
    """Adam with decoupled weight decay (reference :319): default 0.01 on
    every parameter that ``apply_decay_param_fun`` does not exclude."""
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision,
                         apply_decay_param_fun)
