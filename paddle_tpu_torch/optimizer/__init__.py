"""Optimizers: Adam and AdamW (port of ``paddle_tpu/optimizer/__init__.py``).

The reference's dual API, on dicts of tensors keyed by parameter name:

* **Functional**: ``state = opt.init_state(params)``;
  ``new_params, new_state = opt.update(grads, state, params)``. With
  ``multi_precision`` (the default) non-fp32 parameters get fp32
  ``master`` copies, the moments are fp32, and the new parameters are the
  masters cast to the parameter dtype (reference :102-113, :189). With
  ``multi_precision=False`` (the reference's pure-low-precision mode,
  :56-67, :104, :176) there are no masters and the moments live in the
  parameter dtype: the update runs in fp32 from them and is rounded back,
  with the reference's rounding points (a weak Python scalar times a bf16
  slot or parameter rounds in bf16), so a bf16 update is the reference's
  bit for bit.
* **Eager veneer**: ``opt.apply_gradients(named_grads, model=...)``, and the
  PyTorch idiom ``opt.step()`` / ``opt.clear_grad()`` over the ``.grad`` of
  the ``parameters=`` given at construction; both write the new values into
  the parameters in place.

``update`` is pure, as the reference's is: it leaves the state and the
parameters it is given untouched. ``update_`` is its in-place form, which
the eager veneer uses: it advances the state's fp32 slots (moments and
masters) where they lie — at GPT-2 345M that saves 4.3 GB of copies per
step. The arithmetic runs as PyTorch's multi-tensor (``_foreach``) ops, in
the order of the reference's (an XLA fusion there, not a Pallas kernel);
the low-precision mode steps through the parameters in groups of at most
``GROUP_NUMEL`` elements, so its fp32 temporaries stay a few GB at 7 B
parameters. The eager veneer writes each group's new values straight into
the parameters.

``SGD`` (reference :243-250) has no slots: p − lr·(g + wd·p), the L2
decay coupled on the gradients (``apply_decay_param_fun`` may exclude a
parameter), on the fp32 masters under ``multi_precision`` and in the
parameter dtype without; it steps tensor by tensor, in place on the
masters, so its fp32 temporaries stay those of one tensor (ERNIE-3.0
Titan's 6.4 B parameters carry 25.7 GB of masters beside them).

Not ported yet (ROADMAP Queue A item 5): LR schedulers, gradient clipping,
L1 decay and other regularizer objects, Momentum / Lamb and the other
siblings; they raise ``NotImplementedError``.
"""

from typing import Dict

import numpy as np
import torch

_TODO = "(ROADMAP Queue A item 5)"

# elements a group of the low-precision update steps at once: its fp32
# temporaries (grads, moments, direction, new values) stay near
# 8 x 4 bytes x GROUP_NUMEL = 2 GB; one tensor larger than this is a group
GROUP_NUMEL = 1 << 26


def _groups(keys, params):
    """`keys` in order, cut into runs of one dtype and device of at most
    GROUP_NUMEL elements (or one larger tensor)."""
    group, n, kind = [], 0, None
    for k in keys:
        p = params[k]
        if group and ((p.dtype, p.device) != kind
                      or n + p.numel() > GROUP_NUMEL):
            yield group
            group, n = [], 0
        group.append(k)
        n += p.numel()
        kind = (p.dtype, p.device)
    if group:
        yield group


def _in_dtype(c, dtype):
    """The Python scalar `c` rounded to `dtype`: a weak-typed scalar times
    an array of that dtype in the reference."""
    return float(torch.tensor(c, dtype=dtype))


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
        if not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                f"regularizer objects are not ported yet {_TODO}; pass a "
                "float weight_decay")
        self._lr = float(learning_rate)
        self._parameters = list(parameters) if parameters is not None else None
        self.multi_precision = bool(multi_precision)
        self.weight_decay = float(weight_decay)
        self.apply_decay_param_fun = apply_decay_param_fun
        self._eager_state = None

    # -- functional API ------------------------------------------------------

    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict:
        slots = self._init_slots(params)
        if self.multi_precision:
            masters = {k: p.detach().float() for k, p in params.items()
                       if p.dtype != torch.float32}
            if masters:
                slots["master"] = masters
        slots["step"] = 0
        return slots

    def _slot_dtype(self, p):
        """fp32 slots under multi_precision, the parameter's dtype without
        (the reference's ``_slot_zeros``)."""
        return torch.float32 if self.multi_precision else p.dtype

    def _init_slots(self, params):
        raise NotImplementedError

    def update(self, grads, state, params, step=None):
        """(new_params, new_state); `state` and `params` are not touched."""
        fresh = {k: {n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v for k, v in state.items()}
        return self.update_(grads, fresh, params, step)

    def update_(self, grads, state, params, step=None, out=None):
        """update() that advances the moments and masters of `state` in
        place and returns `state` itself as the new state, with its step
        advanced; `params` are not touched, unless they are `out`: given a
        dict of tensors with `params`' keys, the new values are written
        into it (group by group) and it is returned as the new params."""
        step_ = state["step"] if step is None else step
        if not self.multi_precision:
            new_params = self._update_low(grads, state, params, step_, out)
            state["step"] = step_ + 1
            return new_params, state
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
        state["step"] = step_ + 1
        if out is not None:
            with torch.no_grad():
                for i in on_master:
                    out[keys[i]].copy_(masters[keys[i]])
                for i, t in zip(plain, new_plain):
                    out[keys[i]].copy_(t)
            return out, state
        new_params = {keys[i]: masters[keys[i]].to(params[keys[i]].dtype)
                      for i in on_master}
        new_params.update({keys[i]: t for i, t in zip(plain, new_plain)})
        return {k: new_params[k] for k in keys}, state

    def _update_low(self, grads, state, params, step, out):
        """multi_precision=False: the update of each group of parameters
        in fp32 from the parameters and their low-precision moments,
        rounded back to the parameter dtype (into `out`, or new tensors)."""
        keys = list(params)
        new = {} if out is None else out
        for group in _groups(keys, params):
            ps = [params[k].detach() for k in group]
            gf = [grads[k].detach().float() for k in group]
            fresh = self._apply_low(group, gf, ps, state, step)
            with torch.no_grad():
                for k, p, t in zip(group, ps, fresh):
                    if out is None:
                        new[k] = t.to(p.dtype)
                    else:
                        out[k].copy_(t)
            del gf, fresh
        return {k: new[k] for k in keys}

    def _apply(self, keys, grads, work, state, step):
        """Advance the slots in place; return the per-key step direction
        (the update is work − lr · direction)."""
        raise NotImplementedError

    def _apply_low(self, keys, grads, params, state, step):
        """The low-precision form of _apply: advance the slots of `keys`
        in place (stored in their own dtype) and return the new parameter
        values in fp32."""
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
        # each new value only depends on its own old one: written in place
        _, self._eager_state = self.update_(grads, self._eager_state, values,
                                            out=values)

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
        zeros = lambda: {k: torch.zeros(p.shape, dtype=self._slot_dtype(p),
                                        device=p.device)
                         for k, p in params.items()}
        return {"moment1": zeros(), "moment2": zeros()}

    def _bias(self, step):
        """(1 − β1^t, 1 − β2^t) in fp32, as the reference has them."""
        t = np.float32(step + 1)
        return (float(np.float32(1.0) - np.float32(self.beta1) ** t),
                float(np.float32(1.0) - np.float32(self.beta2) ** t))

    def _apply_low(self, keys, grads, params, state, step):
        # the reference's expressions (:293-313) with its promotions: a
        # Python scalar times a low-precision slot or parameter rounds in
        # that dtype (_in_dtype), the fp32 grads promote the rest to fp32;
        # separate multiply and add, no fused forms, as the reference
        # rounds each
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, \
            self.weight_decay
        dt = params[0].dtype
        bias1, bias2 = self._bias(step)
        decay = [i for i, on in enumerate(self._decay_mask(keys)) if on]
        if wd and decay and not self._decoupled_wd:   # coupled L2 on grads
            grads = list(grads)
            wp = torch._foreach_mul([params[i] for i in decay],
                                    _in_dtype(wd, dt))
            for i, w in zip(decay, wp):
                grads[i] = grads[i] + w.float()
        m1 = [state["moment1"][k] for k in keys]
        m2 = [state["moment2"][k] for k in keys]
        m1f = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(m1f, [t.float() for t in torch._foreach_mul(
            m1, _in_dtype(b1, dt))])
        m2f = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(m2f, 1 - b2)
        torch._foreach_add_(m2f, [t.float() for t in torch._foreach_mul(
            m2, _in_dtype(b2, dt))])
        denom = torch._foreach_div(m2f, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        direction = torch._foreach_div(m1f, bias1)
        torch._foreach_div_(direction, denom)
        del denom
        if wd and decay and self._decoupled_wd:       # decoupled: + wd·p
            wp = torch._foreach_mul([params[i] for i in decay],
                                    _in_dtype(wd, dt))
            for i, w in zip(decay, wp):
                direction[i].add_(w.float())
        with torch.no_grad():
            for s, t in zip(m1 + m2, m1f + m2f):
                s.copy_(t)
        torch._foreach_mul_(direction, self._lr)
        return torch._foreach_sub([p.float() for p in params], direction)

    def _apply(self, keys, grads, work, state, step):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        bias1, bias2 = self._bias(step)
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


class SGD(Optimizer):
    """Plain SGD (reference :243-250, over the base class's masters and
    decay :40-133, :187-188): new = p − lr·g with g = grad + wd·p where
    ``apply_decay_param_fun`` allows. With ``multi_precision`` (the
    default) p is the fp32 master of a low-precision parameter, advanced in
    place, and the parameter its cast; fp32 parameters step in fp32.
    Without, p is the parameter itself, the update in fp32 from it and
    rounded back, wd·p rounded in the parameter dtype (a weak Python scalar
    times a low-precision array in the reference). lr·g is rounded before
    the subtraction, as the reference's separate multiply and subtract."""

    def _init_slots(self, params):
        return {}

    def update_(self, grads, state, params, step=None, out=None):
        step_ = state["step"] if step is None else step
        masters = state.get("master", {}) if self.multi_precision else {}
        keys = list(params)
        lr, wd = self._lr, self.weight_decay
        new = {} if out is None else out
        for k, on in zip(keys, self._decay_mask(keys)):
            p = params[k].detach()
            g = grads[k].detach().float()
            w = masters.get(k)
            with torch.no_grad():
                if w is not None or p.dtype == torch.float32 \
                        or self.multi_precision:
                    base = w if w is not None else p.float()
                    if wd and on:
                        g = g + base * wd
                    if w is not None:          # the master, in place
                        w.sub_(g * lr)
                        val = w
                    else:
                        val = base - g * lr
                else:
                    if wd and on:
                        g = g + (p * _in_dtype(wd, p.dtype)).float()
                    val = p.float() - g * lr
                if out is None:
                    new[k] = val.to(p.dtype)
                else:
                    out[k].copy_(val)
            del g
        state["step"] = step_ + 1
        return {k: new[k] for k in keys}, state
