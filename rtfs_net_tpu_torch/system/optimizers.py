"""Optimizer factory (``rtfs_net_tpu/system/optimizers.py``; reference
``src/system/optimizers.py:58-108``).

``adamw``, ``adam`` and ``sgd`` are ``torch.optim``'s classes, which
compute the JAX package's optax rules (AdamW's decoupled weight decay on
every parameter; SGD's weight decay added to the gradient before
momentum). Every other name of the JAX registry is a ``Rule`` below: the
update that ``make_optimizer`` builds there, written out per parameter
from optax 0.2.6 and the JAX package's own transforms, with optax's
constants wherever the JAX registry passes none (``rmsprop`` decays by
0.9 with eps inside the square root, ``adagrad`` starts its accumulator
at 0.1, ``yogi`` at 1e-6, ``adafactor`` factors a matrix whose two
largest dims reach 128, and so on). That is not what the ``torch.optim``
class of the same name computes. Scalars that optax computes in float32
(bias corrections, RAdam's rectification) are computed in float32 here
too, so both packages take the same branch at the same step.

Each rule reads ``group["lr"]`` at every step, as optax's
``inject_hyperparams`` reads the injected rate, so ``set_lr`` and the
schedulers work; its state is tensors and step counts, which
``state_dict()`` and ``load_state_dict()`` carry.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

f32 = np.float32

# every name make_optimizer takes: the JAX registry's
NAMES = ("adamw", "adam", "sgd", "rmsprop", "adagrad", "adamax", "radam", "adabelief", "lamb",
         "lars", "novograd", "yogi", "sm3", "adafactor", "fromage", "lion", "adadelta", "asgd",
         "accsgd", "sgdw", "qhm", "qhadam", "diffgrad", "adamod", "adabound", "pid", "ranger",
         "rangerva", "rangerqh")


def _power(base: float, count: int) -> float:
    """``base ** count`` in float32, as optax computes it."""
    return float(f32(base) ** f32(count))


def _debias(decay: float, count: int) -> float:
    """The bias correction ``1 - decay ** count``, in float32."""
    return float(f32(1) - f32(_power(decay, count)))


def _norm(x, min_norm: float = 0.0):
    """optax's ``safe_norm``: ||x||, or ``min_norm`` where that is larger."""
    norm = torch.linalg.vector_norm(x)
    return torch.where(norm <= min_norm, torch.full_like(norm, min_norm), norm)


def _trust_ratio(update, param, min_norm: float = 0.0, coefficient: float = 1.0):
    """optax's ``scale_by_trust_ratio``: ``update`` scaled by
    coefficient·||param|| / ||update||, or left as it is where a norm is 0."""
    p_norm, u_norm = _norm(param, min_norm), _norm(update, min_norm)
    ratio = coefficient * p_norm / u_norm
    zero = (p_norm == 0) | (u_norm == 0)
    return update * torch.where(zero, torch.ones_like(ratio), ratio)


def _rms(x):
    return torch.sqrt(torch.mean(x * x))


class Rule(torch.optim.Optimizer):
    """One optax update per parameter: ``update(g, p, state, group)``
    returns u, and the parameter becomes p + u. With ``lookahead`` (the
    JAX package's ``_lookahead``: every ``sync_period``-th step the slow
    weights move ``slow_step`` of the way to the fast ones and the
    parameters become the slow weights) the slow weights live in the state."""

    def __init__(self, params, lr: float, lookahead: bool = False, sync_period: int = 6,
                 slow_step: float = 0.5, **hyper):
        super().__init__(params, dict(lr=lr, lookahead=lookahead, sync_period=sync_period,
                                      slow_step=slow_step, **hyper))

    def init(self, p, group) -> dict:
        return {}

    def update(self, g, p, state, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self.init(p, group), step=0)
                    if group["lookahead"]:
                        state["slow"] = p.detach().clone()
                state["step"] += 1
                u = self.update(p.grad, p, state, group)
                if not group["lookahead"]:
                    p.add_(u)
                elif state["step"] % group["sync_period"]:
                    p.add_(u)
                else:
                    slow = state["slow"]
                    slow.add_(group["slow_step"] * (p + u - slow))
                    p.copy_(slow)
        return loss


def _zeros(p):
    return torch.zeros_like(p, memory_format=torch.preserve_format)


def _adam_moments(g, state, b1, b2, optax=True):
    """mu, nu <- the moving averages of g and g². optax computes the second
    as (1 - b2)·(g·g), the JAX package's own transforms as ((1 - b2)·g)·g."""
    state["mu"].mul_(b1).add_((1 - b1) * g)
    state["nu"].mul_(b2).add_((1 - b2) * (g * g) if optax else (1 - b2) * g * g)


class RMSprop(Rule):
    """optax ``rmsprop``: nu = 0.9 nu + 0.1 g², u = -lr g / sqrt(nu + eps),
    then ``trace(momentum)``."""

    def init(self, p, group):
        return {"nu": _zeros(p), "trace": _zeros(p)}

    def update(self, g, p, state, group):
        state["nu"].mul_(group["decay"]).add_((1 - group["decay"]) * (g * g))
        u = -group["lr"] * (torch.rsqrt(state["nu"] + group["eps"]) * g)
        return state["trace"].mul_(group["momentum"]).add_(u).clone()


class Adagrad(Rule):
    """optax ``adagrad``: sum of squares from 0.1, u = -lr g / sqrt(sum + eps)."""

    def init(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])}

    def update(self, g, p, state, group):
        s = state["sum_of_squares"].add_(g * g)
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
        return -group["lr"] * (inv * g)


class Adamax(Rule):
    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        state["mu"].mul_(b1).add_((1 - b1) * g)
        nu = torch.maximum(g.abs() + group["eps"], b2 * state["nu"])
        state["nu"].copy_(nu)
        return -group["lr"] * (state["mu"] / _debias(b1, state["step"]) / nu)


class RAdam(Rule):
    """optax ``radam`` (threshold 5): the rectified Adam step once the
    SMA length rho reaches the threshold, the debiased momentum before."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        t = state["step"]
        _adam_moments(g, state, b1, b2)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = f32(_power(b2, t))
        ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
        mu_hat = state["mu"] / _debias(b1, t)
        if ro < group["threshold"]:
            return -group["lr"] * mu_hat
        r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                          / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        nu_hat = state["nu"] / _debias(b2, t)
        return -group["lr"] * (r * mu_hat / (torch.sqrt(nu_hat) + group["eps"]))


class AdaBelief(Rule):
    """optax ``adabelief`` (eps_root 1e-16)."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        state["mu"].mul_(b1).add_((1 - b1) * g)
        err = g - state["mu"]
        state["nu"].mul_(b2).add_((1 - b2) * (err * err)).add_(group["eps_root"])
        mu_hat = state["mu"] / _debias(b1, state["step"])
        nu_hat = state["nu"] / _debias(b2, state["step"])
        return -group["lr"] * (mu_hat / (torch.sqrt(nu_hat) + group["eps"]))


class Lamb(Rule):
    """optax ``lamb``: the Adam step plus decoupled weight decay, scaled by
    the trust ratio ||p|| / ||u||."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        _adam_moments(g, state, b1, b2)
        u = ((state["mu"] / _debias(b1, state["step"]))
             / (torch.sqrt(state["nu"] / _debias(b2, state["step"])) + group["eps"]))
        u = u + group["weight_decay"] * p
        return -group["lr"] * _trust_ratio(u, p)


class Lars(Rule):
    """optax ``lars`` (trust coefficient 1e-3, weight decay and trust ratio
    on every parameter), then ``trace(momentum)``."""

    def init(self, p, group):
        return {"trace": _zeros(p)}

    def update(self, g, p, state, group):
        u = _trust_ratio(g + group["weight_decay"] * p, p,
                         coefficient=group["trust_coefficient"])
        return state["trace"].mul_(group["momentum"]).add_(-group["lr"] * u).clone()


class NovoGrad(Rule):
    """optax ``novograd``: a per-layer second moment of ||g||² (its first
    value ||g||² itself), mu = b1 mu + g / (sqrt(nu) + eps) + wd p."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        sq = torch.linalg.vector_norm(g) ** 2
        if state["step"] == 1:
            state["nu"].copy_(sq)
        else:
            state["nu"].mul_(b2).add_((1 - b2) * sq)
        add = g / (torch.sqrt(state["nu"]) + group["eps"]) + group["weight_decay"] * p
        if state["step"] == 1:
            state["mu"].copy_(add)
        else:
            state["mu"].mul_(b1).add_(add)
        return -group["lr"] * state["mu"]


class Yogi(Rule):
    """optax ``yogi``: both moments start at 1e-6; nu moves by
    (1 - b2)·sign(nu - g²)·g²."""

    def init(self, p, group):
        v = group["initial_accumulator_value"]
        return {"mu": torch.full_like(p, v), "nu": torch.full_like(p, v)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        state["mu"].mul_(b1).add_((1 - b1) * g)
        g2 = g * g
        nu = state["nu"]
        nu.sub_((1 - b2) * torch.sign(nu - g2) * g2)
        mu_hat = state["mu"] / _debias(b1, state["step"])
        nu_hat = nu / _debias(b2, state["step"])
        return -group["lr"] * (mu_hat / (torch.sqrt(nu_hat) + group["eps"]))


class SM3(Rule):
    """optax ``sm3`` (momentum 0.9): one accumulator per dimension of a
    parameter (one for a vector), the update's accumulator their
    broadcast minimum plus g²."""

    def init(self, p, group):
        return {"mu": [p.new_zeros(s) for s in p.shape], "nu": _zeros(p)}

    def update(self, g, p, state, group):
        shape = lambda i: [1] * i + [g.shape[i]] + [1] * (g.dim() - i - 1)  # noqa: E731
        if g.dim() < 2:
            accum = g * g + state["mu"][0]
        else:
            low = state["mu"][0].reshape(shape(0))
            for i in range(1, g.dim()):
                low = torch.minimum(low, state["mu"][i].reshape(shape(i)))
            accum = g * g + low
        inv = torch.where(accum > 0, torch.rsqrt(accum + group["eps"]), torch.zeros_like(accum))
        b1 = group["momentum"]
        nu = state["nu"].mul_(b1).add_((1 - b1) * (g * inv))
        for i, m in enumerate(state["mu"]):
            other = [d for d in range(g.dim()) if d != i]
            m.copy_(accum if g.dim() < 2 else accum.amax(dim=other))
        return -group["lr"] * nu


class Adafactor(Rule):
    """optax ``adafactor``: a factored second moment (row and column means
    of g² + 1e-30) where a parameter's two largest dims reach 128, else a
    full one, decay 1 - (t + 1)^-0.8; the update clipped to RMS 1, scaled
    by lr and by the parameter's RMS (at least 1e-3)."""

    def _dims(self, p, group):
        if p.dim() < 2:
            return None
        order = np.argsort(p.shape)
        if p.shape[order[-2]] < group["min_dim_size_to_factor"]:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, p, group):
        dims = self._dims(p, group)
        if dims is None:
            return {"v": _zeros(p)}
        d1, d0 = dims
        return {"v_row": p.new_zeros([s for i, s in enumerate(p.shape) if i != d0]),
                "v_col": p.new_zeros([s for i, s in enumerate(p.shape) if i != d1])}

    def update(self, g, p, state, group):
        decay = float(f32(1) - f32(state["step"]) ** f32(-group["decay_rate"]))
        g2 = g * g + group["epsilon"]
        dims = self._dims(p, group)
        if dims is None:
            v = state["v"].mul_(decay).add_((1.0 - decay) * g2)
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(decay).add_((1.0 - decay) * g2.mean(d0))
            v_col = state["v_col"].mul_(decay).add_((1.0 - decay) * g2.mean(d1))
            row_mean = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            u = (g * (v_row / row_mean).pow(-0.5).unsqueeze(d0)
                 * v_col.pow(-0.5).unsqueeze(d1))
        u = u / torch.clamp(_rms(u) / group["clipping_threshold"], min=1.0)
        u = u * group["lr"]
        p_rms = _rms(p)
        u = u * torch.where(p_rms <= 1e-3, torch.full_like(p_rms, 1e-3), p_rms)
        return -u


class Fromage(Rule):
    """optax ``fromage``: the gradient scaled to ||p|| (norms at least
    1e-6), u = -lr·m·that + (m - 1)·p with m = 1/sqrt(1 + lr²)."""

    def update(self, g, p, state, group):
        lr = f32(group["lr"])
        mult = f32(1) / np.sqrt(f32(1) + lr * lr)
        u = -float(lr * mult) * _trust_ratio(g, p, min_norm=group["min_norm"])
        return u + float(mult - f32(1)) * p


class Lion(Rule):
    """optax ``lion`` (b1 0.9, b2 0.99): the sign of the b1-interpolation of
    momentum and gradient, plus weight decay; momentum decays by b2."""

    def init(self, p, group):
        return {"mu": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["lion_betas"]
        u = torch.sign((1.0 - b1) * g + b1 * state["mu"])
        state["mu"].mul_(b2).add_((1 - b2) * g)
        return -group["lr"] * (u + group["weight_decay"] * p)


class Adadelta(Rule):
    """optax ``adadelta`` (rho 0.9), weight decay added to the gradient
    first, and the result scaled by -lr as the JAX registry passes lr."""

    def init(self, p, group):
        return {"e_g": _zeros(p), "e_x": _zeros(p)}

    def update(self, g, p, state, group):
        rho, eps = group["rho"], group["eps"]
        g = g + group["weight_decay"] * p
        e_g = state["e_g"].mul_(rho).add_((1 - rho) * (g * g))
        u = (torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps)) * g
        state["e_x"].mul_(rho).add_((1 - rho) * (u * u))
        return -group["lr"] * u


class HeavyBall(Rule):
    """``asgd``/``accsgd`` as the JAX registry has them: SGD with
    ``trace(momentum)``; ``sgdw``: ``trace(momentum)`` then decoupled
    weight decay."""

    def init(self, p, group):
        return {"trace": _zeros(p)}

    def update(self, g, p, state, group):
        u = state["trace"].mul_(group["momentum"]).add_(g)
        return -group["lr"] * (u + group["weight_decay"] * p)


class QHM(Rule):
    """Quasi-hyperbolic momentum: buf = m buf + (1-m) g, u = (1-nu) g + nu buf."""

    def init(self, p, group):
        return {"buf": _zeros(p)}

    def update(self, g, p, state, group):
        m, nu = group["momentum"], group["nu"]
        buf = state["buf"].mul_(m).add_((1 - m) * g)
        return -group["lr"] * ((1 - nu) * g + nu * buf)


class QHAdam(Rule):
    """QHAdam (nu1 0.7, nu2 1.0) plus weight decay."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        nu1, nu2 = group["nus"]
        _adam_moments(g, state, b1, b2, optax=False)
        mc = state["mu"] / _debias(b1, state["step"])
        vc = state["nu"] / _debias(b2, state["step"])
        u = (((1 - nu1) * g + nu1 * mc)
             / (torch.sqrt((1 - nu2) * g * g + nu2 * vc) + group["eps"]))
        return -group["lr"] * (u + group["weight_decay"] * p)


class DiffGrad(Rule):
    """diffGrad: the Adam step with its momentum scaled by
    sigmoid(|g_prev - g|)."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p), "g_prev": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        _adam_moments(g, state, b1, b2, optax=False)
        friction = torch.sigmoid((state["g_prev"] - g).abs())
        state["g_prev"].copy_(g)
        u = ((friction * (state["mu"] / _debias(b1, state["step"])))
             / (torch.sqrt(state["nu"] / _debias(b2, state["step"])) + group["eps"]))
        return -group["lr"] * u


class AdaMod(Rule):
    """AdaMod (b3 0.999): the Adam step bounded by its exponential average."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p), "s": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        b3 = group["b3"]
        _adam_moments(g, state, b1, b2, optax=False)
        step = ((state["mu"] / _debias(b1, state["step"]))
                / (torch.sqrt(state["nu"] / _debias(b2, state["step"])) + group["eps"]))
        s = state["s"].mul_(b3).add_((1 - b3) * step.abs())
        return -group["lr"] * (torch.sign(step) * torch.minimum(step.abs(), s))


class AdaBound(Rule):
    """AdaBound (final rate 10x the base, gamma 1e-3): the Adam rate
    clipped to bounds that close in on 10·lr."""

    def init(self, p, group):
        return {"mu": _zeros(p), "nu": _zeros(p)}

    def update(self, g, p, state, group):
        b1, b2 = group["betas"]
        t = state["step"]
        _adam_moments(g, state, b1, b2, optax=False)
        ratio, gamma = f32(group["final_lr_ratio"]), f32(group["gamma"])
        tf = f32(t)
        lower = float(ratio * (f32(1) - f32(1) / (gamma * tf + f32(1))))
        upper = float(ratio * (f32(1) + f32(1) / (gamma * tf)))
        rate = torch.clamp(1.0 / (torch.sqrt(state["nu"] / _debias(b2, t)) + group["eps"]),
                           lower, upper)
        return -group["lr"] * (rate * (state["mu"] / _debias(b1, t)))


class PID(Rule):
    """PID (integral 5, derivative 10): g + 5·I + 10·D with I = m I + g
    and D = g - g_prev (0 at the first step)."""

    def init(self, p, group):
        return {"i": _zeros(p), "g_prev": _zeros(p)}

    def update(self, g, p, state, group):
        i = state["i"].mul_(group["momentum"]).add_(g)
        d = _zeros(g) if state["step"] == 1 else g - state["g_prev"]
        state["g_prev"].copy_(g)
        return -group["lr"] * (g + group["integral"] * i + group["derivative"] * d)


def make_optimizer(params: Iterable[torch.nn.Parameter], optimizer: str = "adamw",
                   lr: float = 1e-3, weight_decay: float = 0.0, momentum: float = 0.0,
                   betas=(0.9, 0.999), eps: float = 1e-8,
                   **kwargs) -> torch.optim.Optimizer:
    """An optimizer over ``params`` by name (case-insensitive, the config's
    ``optim`` section as keyword arguments), with the JAX registry's rule
    and hyperparameters for that name."""
    name = optimizer.lower()
    if name not in NAMES:
        raise ValueError(f"Could not interpret optimizer identifier: {optimizer}")
    betas = tuple(betas)
    adam = dict(betas=betas, eps=eps)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                 weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)
    if name == "rmsprop":
        return RMSprop(params, lr, decay=0.9, eps=eps, momentum=momentum)
    if name == "adagrad":
        return Adagrad(params, lr, initial_accumulator_value=0.1, eps=eps)
    if name == "adamax":
        return Adamax(params, lr, **adam)
    if name in ("radam", "ranger", "rangerva"):
        # ranger = RAdam + lookahead (RangerVA as the same composition)
        return RAdam(params, lr, lookahead=name != "radam", threshold=5.0, **adam)
    if name == "adabelief":
        return AdaBelief(params, lr, eps_root=1e-16, **adam)
    if name == "lamb":
        return Lamb(params, lr, weight_decay=weight_decay, **adam)
    if name == "lars":
        return Lars(params, lr, weight_decay=weight_decay, momentum=momentum,
                    trust_coefficient=1e-3)
    if name == "novograd":
        return NovoGrad(params, lr, weight_decay=weight_decay, **adam)
    if name == "yogi":
        return Yogi(params, lr, initial_accumulator_value=1e-6, **adam)
    if name == "sm3":
        return SM3(params, lr, momentum=0.9, eps=1e-8)
    if name == "adafactor":
        return Adafactor(params, lr, min_dim_size_to_factor=128, decay_rate=0.8,
                         epsilon=1e-30, clipping_threshold=1.0)
    if name == "fromage":
        return Fromage(params, lr, min_norm=1e-6)
    if name == "lion":
        return Lion(params, lr, lion_betas=(0.9, 0.99), weight_decay=weight_decay)
    if name == "adadelta":
        return Adadelta(params, lr, rho=0.9, eps=eps, weight_decay=weight_decay)
    if name in ("asgd", "accsgd"):
        return HeavyBall(params, lr, momentum=momentum or 0.9, weight_decay=0.0)
    if name == "sgdw":
        return HeavyBall(params, lr, momentum=momentum, weight_decay=weight_decay)
    if name == "qhm":
        return QHM(params, lr, momentum=momentum or 0.999, nu=0.7)
    if name in ("qhadam", "rangerqh"):
        # rangerqh = QHAdam (no weight decay) + lookahead
        return QHAdam(params, lr, lookahead=name == "rangerqh", nus=(0.7, 1.0),
                      weight_decay=weight_decay if name == "qhadam" else 0.0, **adam)
    if name == "diffgrad":
        return DiffGrad(params, lr, **adam)
    if name == "adamod":
        return AdaMod(params, lr, b3=0.999, **adam)
    if name == "adabound":
        return AdaBound(params, lr, final_lr_ratio=10.0, gamma=1e-3, **adam)
    assert name == "pid"
    return PID(params, lr, momentum=momentum or 0.9, integral=5.0, derivative=10.0)


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
