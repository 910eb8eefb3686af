"""GAE and PPO's clipped update (SB3's PPO, with the JAX package's
choices the port keeps): population std of the minibatch's advantages
with a floor, value loss without clipping, gradients clipped by global
norm as optax does it (scaled only when the norm reaches the limit),
and Adam with optax's arithmetic: bias corrections 1 - b^t computed in
float32 with b rounded to float32, p -= lr mu_hat / (sqrt(nu_hat) + eps).

``hp`` is the traffic file's ``ppo`` block.
"""
import numpy as np
import torch

from reference import policy


def gae(reward, done, value, last_value, gamma: float, lam: float):
    """(advantages, returns), each (T, N), from (T, N) rewards, dones and
    values and the bootstrap value (N,) after the last step."""
    adv = torch.zeros_like(last_value)
    nxt = last_value
    out = []
    for t in reversed(range(reward.shape[0])):
        nonterminal = 1.0 - done[t].to(reward.dtype)
        delta = reward[t] + gamma * nxt * nonterminal - value[t]
        adv = delta + gamma * lam * nonterminal * adv
        out.append(adv)
        nxt = value[t]
    adv = torch.stack(out[::-1])
    return adv, adv + value


def loss(params, mb, hp, adv_all=None):
    """Total loss of one minibatch (obs, action, old_logp, old_value,
    adv, ret), its advantages normalized by the mean and std of
    ``adv_all`` (default: its own; a data-parallel rank's part of a
    minibatch is normalized by the whole minibatch's)."""
    obs, action, old_logp, old_value, adv, ret = mb
    if adv_all is None:
        adv_all = adv
    mean, log_std, value = policy.forward(params, obs, hp["log_std_min"],
                                          hp["log_std_max"])
    logp = policy.gaussian_logp(action, mean, log_std)
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv_all.mean()) / torch.clamp(
        adv_all.std(unbiased=False), min=hp["adv_std_floor"])
    pg = torch.maximum(-adv_n * ratio, -adv_n * torch.clamp(
        ratio, 1 - hp["clip_eps"], 1 + hp["clip_eps"])).mean()
    v_loss = 0.5 * ((value - ret) ** 2).mean()
    ent = policy.gaussian_entropy(log_std).mean()
    return pg + hp["vf_coef"] * v_loss - hp["ent_coef"] * ent


def _f32(x) -> float:
    return float(np.float32(x))


def update_steps(params, minibatches, hp, part=None):
    """Adam steps of the clipped update from ``params``, one per
    minibatch. Returns (losses, first gradient as Adam gets it (after the
    clip), params after the last step), the last two dicts keyed like
    ``params``. With ``part``, the losses are those of each minibatch's
    first ``part`` rows (a data-parallel rank 0's share); the gradient
    is the whole minibatch's, which is the mean of the parts'."""
    names = list(params)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = 0.9, 0.999
    losses, first_grad = [], None
    for count, mb in enumerate(minibatches, 1):
        total = loss(p, mb, hp)
        grads = torch.autograd.grad(total, [p[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(names, grads)]
        if part is not None:
            with torch.no_grad():
                total = loss(p, [x[:part] for x in mb], hp, mb[4])
        losses.append(float(total.detach()))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            if float(norm) >= hp["max_grad_norm"]:
                grads = [g / norm * hp["max_grad_norm"] for g in grads]
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in zip(names, grads)}
            bc1 = _f32(1.0 - np.float32(b1) ** np.float32(count))
            bc2 = _f32(1.0 - np.float32(b2) ** np.float32(count))
            for k, g in zip(names, grads):
                mu[k] = mu[k] + (g - mu[k]) * (1.0 - b1)
                nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
                p[k] -= hp["lr"] * (mu[k] / bc1) / (
                    torch.sqrt(nu[k] / bc2) + hp["adam_eps"])
    return losses, first_grad, {k: v.detach() for k, v in p.items()}
