"""Probability distributions (python/paddle/fluid/layers/
distributions.py): Uniform, Normal, Categorical and MultivariateNormalDiag
with the reference's sample / entropy / log_prob / kl_divergence.

Counterpart of paddle_tpu/static/distributions.py: the methods are
torch arithmetic on tensors (float32); a graph Variable is refused, as
in the JAX package. A parameter given as a tensor keeps its device,
anything else goes to `device` (None means CUDA and raises without a
GPU). `sample(shape, seed)` draws from a `torch.Generator` seeded from
`seed` and a per-process draw count, so repeated calls differ while the
same sequence of calls repeats; the numbers are torch's, not
`jax.random`'s, so samples are held by their moments (ROADMAP Queue 3).
"""
import math

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.places import resolve_device

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag"]

_draws = [0]


def _arr(v, device):
    from paddle_tpu_torch.core.ir import Variable
    if isinstance(v, Variable):
        raise NotImplementedError(
            "distributions on graph Variables: build the distribution "
            "over tensors instead (the fluid classes inline ops; here the "
            "methods are the ops)")
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.as_tensor(v, dtype=torch.float32,
                           device=resolve_device(device))


def _generator(seed, device):
    """A generator for one draw: the seed folded with the draw count."""
    _draws[0] += 1
    mixed = (int(seed) * 1_000_003 + _draws[0] * 7_919) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


class Distribution:
    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    """U(low, high) (distributions.py:113)."""

    def __init__(self, low, high, device=None):
        self.low = _arr(low, device)
        self.high = _arr(high, self.low.device)

    def sample(self, shape, seed=0):
        dev = self.low.device
        u = torch.rand(tuple(shape) + tuple(self.low.shape),
                       generator=_generator(seed, dev), device=dev)
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        v = _arr(value, self.low.device)
        inside = (v > self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    def __init__(self, loc, scale, device=None):
        self.loc = _arr(loc, device)
        self.scale = _arr(scale, self.loc.device)

    def sample(self, shape, seed=0):
        dev = self.loc.device
        z = torch.randn(tuple(shape) + tuple(self.loc.shape),
                        generator=_generator(seed, dev), device=dev)
        return self.loc + z * self.scale

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def log_prob(self, value):
        v = _arr(value, self.loc.device)
        var = self.scale * self.scale
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def kl_divergence(self, other):
        enforce(isinstance(other, Normal), "KL(Normal || Normal) only")
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Categorical(Distribution):
    """Categorical over unnormalized logits (distributions.py:400)."""

    def __init__(self, logits, device=None):
        self.logits = _arr(logits, device)

    def sample(self, shape, seed=0):
        """shape + the batch dims of the logits, int64 categories."""
        k = self.logits.shape[-1]
        n = math.prod(shape)
        probs = torch.softmax(self.logits, dim=-1).reshape(-1, k)
        draws = torch.multinomial(probs, n, replacement=True,
                                  generator=_generator(
                                      seed, self.logits.device))
        batch = tuple(self.logits.shape[:-1])
        return draws.T.reshape(tuple(shape) + batch)

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(torch.softmax(self.logits, dim=-1) * logp, dim=-1)

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        idx = torch.as_tensor(value, device=logp.device).long()
        return torch.gather(logp.expand(tuple(idx.shape) + (logp.shape[-1],)),
                            -1, idx[..., None])[..., 0]

    def kl_divergence(self, other):
        enforce(isinstance(other, Categorical),
                "KL(Categorical || Categorical) only")
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return torch.sum(torch.softmax(self.logits, dim=-1) * (logp - logq),
                         dim=-1)


class MultivariateNormalDiag(Distribution):
    def __init__(self, loc, scale, device=None):
        self.loc = _arr(loc, device)
        self.scale = _arr(scale, self.loc.device)  # [D, D], diagonal
        self._diag = torch.diagonal(self.scale, dim1=-2, dim2=-1)

    def sample(self, shape, seed=0):
        dev = self.loc.device
        z = torch.randn(tuple(shape) + tuple(self.loc.shape),
                        generator=_generator(seed, dev), device=dev)
        return self.loc + z * self._diag

    def entropy(self):
        d = self.loc.shape[-1]
        return (0.5 * d * (1.0 + math.log(2 * math.pi))
                + torch.sum(torch.log(self._diag), dim=-1))

    def log_prob(self, value):
        v = _arr(value, self.loc.device)
        d = self.loc.shape[-1]
        return (-0.5 * torch.sum(((v - self.loc) / self._diag) ** 2, -1)
                - torch.sum(torch.log(self._diag), -1)
                - 0.5 * d * math.log(2 * math.pi))

    def kl_divergence(self, other):
        enforce(isinstance(other, MultivariateNormalDiag),
                "KL(MVNDiag || MVNDiag) only")
        var1 = self._diag ** 2
        var2 = other._diag ** 2
        return 0.5 * torch.sum(
            var1 / var2 + (self.loc - other.loc) ** 2 / var2
            - 1.0 + torch.log(var2) - torch.log(var1), dim=-1)
