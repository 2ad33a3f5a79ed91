"""Neural architecture search.

Counterpart of paddle_tpu/slim/nas.py (the reference's
contrib/slim/searcher/controller.py EvolutionaryController /
SAController, nas/search_space.py's SearchSpace contract and
light_nas_strategy.py's search loop under a FLOPs constraint). The loop
is local: training each candidate is the costly part, and it runs on the
card through the port's own entry points.

`flops_of` counts one call's operations with
`torch.utils.flop_counter.FlopCounterMode`. It agrees with the JAX
package's XLA cost analysis on a matmul (2 * M * N * K). It differs on a
conv net: FlopCounterMode counts every tap of a padded convolution and
no elementwise op (activations, adds, batch norm), where XLA counts only
the taps inside the input and charges the elementwise work.
"""
import math

import numpy as np

from paddle_tpu_torch.core.enforce import enforce


class EvolutionaryController:
    """Abstract evolutionary controller (controller.py:11)."""

    def reset(self, range_table, init_tokens=None, constrain_func=None):
        raise NotImplementedError

    def next_tokens(self):
        raise NotImplementedError

    def update(self, tokens, reward):
        raise NotImplementedError


class SAController(EvolutionaryController):
    """Simulated-annealing token search (controller.py SAController):
    propose a random mutation of the current tokens; accept improvements
    always and regressions with probability exp(delta / T); decay T."""

    def __init__(self, range_table=None, reduce_rate=0.85,
                 init_temperature=1024.0, max_iter_number=300, seed=0):
        self._range_table = list(range_table or [])
        self._reduce_rate = reduce_rate
        self._init_temperature = init_temperature
        self._max_iter = max_iter_number
        self._rng = np.random.RandomState(seed)
        self._constrain = None
        self._tokens = None
        self._reward = -np.inf
        self._iter = 0
        self.best_tokens = None
        self.best_reward = -np.inf

    def reset(self, range_table, init_tokens=None, constrain_func=None):
        self._range_table = list(range_table)
        self._constrain = constrain_func
        self._tokens = (list(init_tokens) if init_tokens is not None else
                        [int(self._rng.randint(0, r))
                         for r in self._range_table])
        self._reward = -np.inf
        self._iter = 0
        self.best_tokens = list(self._tokens)
        self.best_reward = -np.inf
        return self._tokens

    def _temperature(self):
        return self._init_temperature * (self._reduce_rate ** self._iter)

    def next_tokens(self):
        """Mutate one random position; re-draw until the constraint (if
        any) admits the candidate, with a bounded number of tries."""
        enforce(self._tokens is not None, "call reset() first")
        for _ in range(100):
            cand = list(self._tokens)
            pos = int(self._rng.randint(0, len(cand)))
            cand[pos] = int(self._rng.randint(0, self._range_table[pos]))
            if self._constrain is None or self._constrain(cand):
                return cand
        return list(self._tokens)

    def update(self, tokens, reward):
        self._iter += 1
        temp = max(self._temperature(), 1e-9)
        delta = reward - self._reward
        if delta >= 0 or self._rng.rand() < math.exp(delta / temp):
            self._tokens = list(tokens)
            self._reward = reward
        if reward > self.best_reward:
            self.best_reward = reward
            self.best_tokens = list(tokens)
        return self._iter < self._max_iter


class SearchSpace:
    """Search-space contract (search_space.py:19)."""

    def init_tokens(self):
        raise NotImplementedError

    def range_table(self):
        raise NotImplementedError

    def create_net(self, tokens):
        """tokens → (train_fn/program, eval_fn) — caller-defined shape."""
        raise NotImplementedError


def flops_of(fn, *example_args):
    """Operations of one call of `fn(*example_args)`, as
    torch.utils.flop_counter.FlopCounterMode counts them (matmuls,
    convolutions, attention; 2 per multiply-add). Runs `fn` once,
    without autograd, on whatever device its arguments live on."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*example_args)
    return float(counter.get_total_flops())


class NASSearcher:
    """light_nas_strategy.py analogue: drive a controller over a search
    space, calling `eval_fn(tokens) -> reward` (train-and-score a
    candidate) under an optional constraint."""

    def __init__(self, space, controller=None, max_flops=None,
                 flops_fn=None, search_steps=50):
        self.space = space
        self.controller = controller or SAController()
        self.search_steps = search_steps
        constrain = None
        if max_flops is not None:
            enforce(flops_fn is not None,
                    "max_flops needs flops_fn(tokens) -> flops")
            constrain = lambda t: flops_fn(t) <= max_flops  # noqa: E731
        self.controller.reset(space.range_table(), space.init_tokens(),
                              constrain)

    def search(self, eval_fn):
        history = []
        for _ in range(self.search_steps):
            tokens = self.controller.next_tokens()
            reward = float(eval_fn(tokens))
            history.append((tokens, reward))
            if not self.controller.update(tokens, reward):
                break  # controller budget (max_iter_number) exhausted
        return self.controller.best_tokens, self.controller.best_reward, \
            history
