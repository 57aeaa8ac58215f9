"""Linear assignment by the Jacobi auction algorithm, counterpart of
``siu3r_tpu/ops/lap.py``.

The same two regimes, rounds, epsilons and tie-break (the lowest row wins a
column) as the JAX package, over a batch of problems at once (the matcher
solves every decoder layer and batch item in one call):
  * ``2R <= C`` (the training case: the padded ground-truth objects against
    the queries): one round from all-zero prices at eps = spread / 250000,
    then two rescue rounds at 64x and 4096x that eps, carrying the prices and
    the assignment;
  * otherwise: dummy rows make the problem square, and seven rounds of eps
    scaling (spread / 4 down by 5x a round) with persistent prices.
Invalid rows are masked out and reported as -1.

The JAX loop tests its condition on the device. Here each test is a copy to
the host that waits for the device (a host sync), so the rounds run their
iterations in blocks of ``BLOCK`` and test convergence once after each block;
an iteration after a problem has converged changes nothing, so the results
are those of the JAX loop. A round that has converged ends the regime's
remaining rescue rounds without running them (they would not iterate). A
typical training step converges within the first block: one host sync.
A valid row that no round assigned is returned as -1, as the JAX package
returns it; the criterion drops it (it masks ``assignment >= 0``).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e18
BLOCK = 32


def _bid(benefit, valid, prices, eps, owner, row_of):
    """One Jacobi auction iteration on every problem of the batch, in place.
    benefit [N, R, C]; valid [N, R]; prices [N, C]; eps [N, 1]; owner [N, C + 1]
    (column -> row, -1 none; the last column takes dropped writes); row_of
    [N, R + 1] (row -> column, -1 none; the last row likewise)."""
    n, r, c = benefit.shape
    rows = torch.arange(r, device=benefit.device).expand(n, r)
    values = benefit - prices[:, None, :]
    best_v, best_j = values.max(dim=-1)  # the first maximal column, as top_k
    second_v = values.scatter(-1, best_j[..., None], float("-inf")).amax(dim=-1)
    bids = prices.gather(1, best_j) + (best_v - second_v) + eps
    bidding = (row_of[:, :r] < 0) & valid
    neg = bids.new_full((), _NEG)
    bids = torch.where(bidding, bids, neg)
    col_best = bids.new_full((n, c), _NEG).scatter_reduce(1, best_j, bids, "amax")
    is_cand = bidding & (bids >= col_best.gather(1, best_j)) & (bids > neg)
    # the lowest candidate row wins its column
    winner = torch.full((n, c + 1), r, dtype=torch.int64, device=benefit.device).scatter_reduce(
        1, torch.where(is_cand, best_j, c), rows, "amin")
    won = is_cand & (winner.gather(1, best_j) == rows)
    win_cols = torch.where(won, best_j, c)
    prev_owner = torch.where(won, owner.gather(1, best_j), -1)
    row_of.scatter_(1, torch.where(prev_owner >= 0, prev_owner, r), -1)
    owner.scatter_(1, win_cols, rows)
    row_of.scatter_(1, torch.where(won, rows, r), win_cols)
    prices_pad = torch.cat([prices, prices.new_zeros(n, 1)], dim=1)
    prices_pad.scatter_(1, win_cols, torch.where(won, bids, bids.new_zeros(())))
    prices.copy_(prices_pad[:, :c])


def _unassigned(valid, row_of) -> bool:
    """Whether a valid row is left unassigned: one host sync."""
    return bool(((row_of[:, :-1] < 0) & valid).any())


def _auction_round(benefit, valid, prices, eps, max_iters, owner=None, row_of=None):
    """Bid until every valid row of every problem is assigned or ``max_iters``
    iterations have run. Returns (owner, row_of, whether a valid row is left
    unassigned); prices are updated in place."""
    n, r, c = benefit.shape
    if owner is None:
        owner = torch.full((n, c + 1), -1, dtype=torch.int64, device=benefit.device)
        row_of = torch.full((n, r + 1), -1, dtype=torch.int64, device=benefit.device)
    done = 0
    left = True
    while done < max_iters:
        for _ in range(min(BLOCK, max_iters - done)):
            _bid(benefit, valid, prices, eps, owner, row_of)
        done += min(BLOCK, max_iters - done)
        left = _unassigned(valid, row_of)
        if not left:
            break
    return owner, row_of, left


def auction_lap(
    cost: torch.Tensor,
    row_valid: Optional[torch.Tensor] = None,
    eps_scale: int = 7,
    max_iters: int = 4000,
) -> torch.Tensor:
    """cost [..., R, C] float32 (R <= C); row_valid [..., R] bool (invalid rows
    get -1). Returns the assigned column per row [..., R] int64; a valid row
    left unassigned after every round's ``max_iters`` is -1 too."""
    *lead, r, c = cost.shape
    if r > c:
        raise ValueError("auction_lap expects rows <= cols")
    cost = cost.reshape(-1, r, c).float()
    n = cost.shape[0]
    valid = (torch.ones((n, r), dtype=torch.bool, device=cost.device) if row_valid is None
             else row_valid.reshape(n, r))
    zero = cost.new_zeros(())

    if 2 * r <= c:
        benefit = torch.where(valid[..., None], -cost, zero)
        spread = torch.clamp(benefit.abs().amax(dim=(1, 2)), min=1.0)[:, None]
        eps0 = spread / 250000.0
        prices = cost.new_zeros((n, c))
        owner, row_of, left = _auction_round(benefit, valid, prices, eps0, max_iters)
        for k in (64.0, 4096.0):
            if not left:
                break
            owner, row_of, left = _auction_round(benefit, valid, prices, eps0 * k, max_iters, owner, row_of)
        rows = row_of[:, :r]
    else:
        benefit = cost.new_zeros((n, c, c))
        benefit[:, :r] = torch.where(valid[..., None], -cost, zero)
        all_valid = torch.ones((n, c), dtype=torch.bool, device=cost.device)
        spread = torch.clamp(benefit.abs().amax(dim=(1, 2)), min=1.0)[:, None]
        eps0 = spread / 4.0
        prices = cost.new_zeros((n, c))
        for i in range(eps_scale):
            eps = eps0 / 5.0**i
            _, row_of, _ = _auction_round(benefit, all_valid, prices, eps, max_iters)
        rows = row_of[:, :r]
    return torch.where(valid, rows, torch.full_like(rows, -1)).reshape(*lead, r)
