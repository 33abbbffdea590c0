"""PPO learner (counterpart of ``ray_tpu/rl/ppo.py``): clipped surrogate,
GAE and an entropy bonus, with the whole update (every epoch's minibatch
steps) as one device program: a CUDA graph on the card, eager on the CPU.

Parameters keep the reference's tree, ``{"pi"|"vf": [{"w": [in, out],
"b": [out]}, ...]}``, as tensors that the update changes in place (the
graph's static buffers: ``get_weights`` hands out the live tree, and
``set_weights`` copies into it). The optimizer is the reference's
``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` written out
(``_Adam``). The update's randomness is one permutation of the batch per
epoch, ``argsort`` of uniforms from the learner's own generator;
``update(rollout, perms)`` takes the permutations as arguments instead, so
a test can pass the reference's ``jax.random.permutation``s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl._graph import GraphProgram


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    hidden: Tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    num_minibatches: int = 4
    max_grad_norm: float = 0.5


class Rollout(NamedTuple):
    obs: torch.Tensor        # [T, N, obs_dim]
    actions: torch.Tensor    # [T, N] int64 (the reference's are int32)
    log_probs: torch.Tensor  # [T, N]
    rewards: torch.Tensor    # [T, N]
    dones: torch.Tensor      # [T, N] bool
    values: torch.Tensor     # [T+1, N]


def init_policy(gen: torch.Generator, obs_dim: int, num_actions: int,
                hidden) -> Dict:
    """Separate policy/value MLP towers with the reference's scales:
    normal weights times sqrt(2 / fan_in), 0.01 for each tower's last
    layer, zero biases; drawn from ``gen`` on its device. Pendulum's
    ``num_actions=0`` gives a 1-logit policy, as in the reference."""
    params = {}
    for tower, out_dim in (("pi", max(num_actions, 1)), ("vf", 1)):
        sizes = (obs_dim,) + tuple(hidden) + (out_dim,)
        layers = []
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            scale = 0.01 if i == len(sizes) - 2 else math.sqrt(2.0 / a)
            layers.append({
                "w": torch.randn((a, b), generator=gen,
                                 device=gen.device) * scale,
                "b": torch.zeros((b,), device=gen.device),
            })
        params[tower] = layers
    return params


def leaves(params: Dict) -> List[torch.Tensor]:
    """The tree's tensors in a fixed order: each tower's layers, w then
    b."""
    return [lyr[k] for tower in ("pi", "vf") for lyr in params[tower]
            for k in ("w", "b")]


def clone_params(params: Dict, requires_grad: bool = False) -> Dict:
    return {tower: [{k: t.detach().clone().requires_grad_(requires_grad)
                     for k, t in lyr.items()} for lyr in layers]
            for tower, layers in params.items()}


def copy_params_(dst: Dict, src: Dict) -> None:
    """Copies ``src`` into ``dst`` in place (``dst``'s tensors may be a
    graph's static buffers). Raises on a tree or shape mismatch."""
    a, b = leaves(dst), leaves(src)
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise ValueError(f"parameter tree mismatch: "
                         f"{[tuple(x.shape) for x in a]} != "
                         f"{[tuple(y.shape) for y in b]}")
    with torch.no_grad():
        for x, y in zip(a, b):
            x.copy_(y)


def _mlp(layers, x):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def policy_logits(params, obs):
    return _mlp(params["pi"], obs)


def value_fn(params, obs):
    return _mlp(params["vf"], obs)[..., 0]


def gae_advantages(rewards, dones, values, gamma, lam):
    """values: [T+1, N]; returns (advantages [T,N], targets [T,N]), by the
    reference's reverse scan written as a loop over T."""
    adv = torch.zeros_like(rewards[0])
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nonterm = 1.0 - dones[t].float()
        delta = rewards[t] + gamma * values[t + 1] * nonterm - values[t]
        adv = delta + gamma * lam * nonterm * adv
        advs[t] = adv
    advs = torch.stack(advs)
    return advs, advs + values[:-1]


def ppo_loss(params, batch, cfg: PPOConfig):
    """The reference's ``loss_fn``: (total, (pg, vf, ent))."""
    obs, actions, old_logp, advs, targets = batch
    logits = policy_logits(params, obs)
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(-1, actions[..., None].long())[..., 0]
    ratio = torch.exp(logp - old_logp)
    # jnp's std is the population std (correction 0).
    advs_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * advs_n,
        torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * advs_n).mean()
    v = value_fn(params, obs)
    vf = torch.mean((v - targets) ** 2)
    ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
    total = pg + cfg.vf_coeff * vf - cfg.entropy_coeff * ent
    return total, (pg, vf, ent)


class _Adam:
    """``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt),
    after ``optax.clip_by_global_norm(max_norm)`` when ``max_norm`` is
    set, over a list of tensors updated in place. No host sync, so it
    runs inside a CUDA graph; its moments and count are tensors."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 max_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.max_norm, self.b1, self.b2, self.eps = (
            lr, max_norm, b1, b2, eps)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), device=params[0].device)

    def state(self) -> List[torch.Tensor]:
        return [*self.mu, *self.nu, self.count]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        if self.max_norm is not None:
            # optax scales by max / norm only when norm >= max (no eps).
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, g / norm * self.max_norm)
                     for g in grads]
        self.count.add_(1.0)
        bc1 = 1 - torch.pow(self.b1, self.count)
        bc2 = 1 - torch.pow(self.b2, self.count)
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(-self.lr * u)


class PPOLearner:
    """Owns the parameters and the optimizer; ``update`` runs the whole
    PPO update over a Rollout as one device program."""

    def __init__(self, env, config: PPOConfig = PPOConfig(), seed: int = 0,
                 device="cuda"):
        self.env = env
        self.config = config
        self.device = resolve_device(device)
        init = torch.Generator(device=self.device).manual_seed(seed)
        self.params = clone_params(init_policy(
            init, env.obs_dim, env.num_actions, config.hidden), True)
        self._leaves = leaves(self.params)
        self._opt = _Adam(self._leaves, config.lr, config.max_grad_norm)
        # One permutation per epoch is drawn from here.
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 777)
        # Rollout shapes -> (static rollout, GraphProgram).
        self._programs: Dict[tuple, tuple] = {}

    def _update(self, rollout: Rollout, perms: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        advs, targets = gae_advantages(
            rollout.rewards, rollout.dones, rollout.values, cfg.gamma,
            cfg.gae_lambda)
        T, N = rollout.actions.shape
        B = T * N
        flat = (rollout.obs.reshape(B, -1), rollout.actions.reshape(B),
                rollout.log_probs.reshape(B), advs.reshape(B),
                targets.reshape(B))
        mb = B // cfg.num_minibatches
        epoch_losses = []
        for e in range(cfg.num_epochs):
            losses = []
            for i in range(cfg.num_minibatches):
                idx = perms[e, i * mb:(i + 1) * mb]
                batch = tuple(x[idx] for x in flat)
                with torch.enable_grad():
                    loss, _ = ppo_loss(self.params, batch, cfg)
                    grads = torch.autograd.grad(loss, self._leaves)
                self._opt.step(self._leaves, grads)
                losses.append(loss.detach())
            epoch_losses.append(torch.stack(losses).mean())
        return torch.stack(epoch_losses).mean()

    def _draw_perms(self, B: int) -> torch.Tensor:
        return torch.argsort(torch.rand(
            (self.config.num_epochs, B), generator=self.generator,
            device=self.device), dim=-1)

    def _program(self, rollout: Rollout):
        shapes = tuple(tuple(t.shape) for t in rollout)
        entry = self._programs.get(shapes)
        if entry is None:
            static = Rollout(*(torch.empty_like(t, device=self.device)
                               for t in rollout))
            B = rollout.actions.numel()
            program = GraphProgram(
                lambda: self._update(static, self._draw_perms(B)),
                self.device, state=self._leaves + self._opt.state(),
                generators=[self.generator])
            entry = self._programs[shapes] = (static, program)
        return entry

    def update(self, rollout: Rollout, perms=None) -> float:
        """One PPO update over ``rollout``; returns the mean minibatch
        loss. ``perms`` ([num_epochs, T*N] indices), when given, replaces
        the permutations the learner would draw, eagerly."""
        if perms is not None:
            rollout = Rollout(*(t.to(self.device) for t in rollout))
            perms = torch.as_tensor(perms, device=self.device).long()
            return float(self._update(rollout, perms))
        static, program = self._program(rollout)
        with torch.no_grad():
            for dst, src in zip(static, rollout):
                dst.copy_(src)
        return float(program())

    def get_weights(self):
        return self.params

    def set_weights(self, params):
        copy_params_(self.params, params)


def policy_params_from_jax(tree: Dict, device="cuda") -> Dict:
    """The reference's policy tree (``init_policy``'s layout, leaves as
    numpy arrays: the caller runs ``np.asarray`` on the JAX side) as the
    port's tree of f32 tensors on ``device``. Raises on a missing or extra
    key, and on shapes that do not chain into two MLP towers over one
    observation width with a 1-wide value head."""
    dev = resolve_device(device)
    if set(tree) != {"pi", "vf"}:
        raise KeyError(f"unexpected policy keys {sorted(tree)}; want "
                       f"['pi', 'vf']")
    out, in_dims = {}, set()
    for tower in ("pi", "vf"):
        layers = tree[tower]
        if not layers:
            raise ValueError(f"{tower}: no layers")
        converted = []
        for i, lyr in enumerate(layers):
            if set(lyr) != {"w", "b"}:
                raise KeyError(f"{tower}[{i}]: unexpected keys "
                               f"{sorted(lyr)}; want ['b', 'w']")
            w, b = np.asarray(lyr["w"]), np.asarray(lyr["b"])
            want_in = w.shape[0] if i == 0 else converted[-1]["w"].shape[1]
            if w.ndim != 2 or w.shape[0] != want_in or b.shape != w.shape[1:]:
                raise ValueError(f"{tower}[{i}]: w {w.shape}, b {b.shape} "
                                 f"do not chain from width {want_in}")
            converted.append({k: torch.from_numpy(
                np.array(a, dtype=np.float32)).to(dev)
                for k, a in (("w", w), ("b", b))})
        in_dims.add(converted[0]["w"].shape[0])
        out[tower] = converted
    if len(in_dims) != 1 or out["vf"][-1]["w"].shape[1] != 1:
        raise ValueError(f"towers over observation widths {sorted(in_dims)}"
                         f" with a value head of width "
                         f"{out['vf'][-1]['w'].shape[1]}; want one width "
                         f"and 1")
    return out
