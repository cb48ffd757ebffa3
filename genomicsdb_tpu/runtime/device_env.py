"""Process-level device settings shared by the entry points.

* `init_compile_cache` — JAX's persistent compilation cache.  A
  `JAX_COMPILATION_CACHE_DIR` from the environment wins; otherwise the
  cache lives in a fixed directory of the checkout (listed in
  .gitignore).  The path is part of the cache key, so it is never made
  from a temporary name, a process id or the time.
* `rank_env` — the environment of one worker process when several JAX
  processes share the cards of one host (gdb_query --parallel-ranks,
  RankPool, local-Spark executors).  A JAX process reserves most of a
  card's memory when it first uses it, so each worker gets an explicit
  share: 0.9 of a card split between the workers placed on it, and with
  several cards, its own card through CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

# share of one card's memory handed out to the workers placed on it
CARD_MEMORY_SHARE = 0.9


def init_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def visible_cards() -> list:
    """Card ids this process may hand out, without opening a device:
    CUDA_VISIBLE_DEVICES when set, else the CUDA ordinals of the cards
    `nvidia-smi -L` lists (none when it is absent or fails)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [c for c in vis.split(",") if c.strip()]
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if r.returncode != 0:
        return []
    n = sum(line.startswith("GPU ") for line in r.stdout.splitlines())
    return [str(i) for i in range(n)]


def rank_env(index: int, n_workers: int,
             base: Optional[Dict[str, str]] = None,
             cards: Optional[list] = None) -> Dict[str, str]:
    """Environment for worker `index` of `n_workers` JAX processes.
    Workers are dealt round-robin over the cards; those sharing a card
    split CARD_MEMORY_SHARE of it evenly."""
    env = dict(os.environ if base is None else base)
    cards = visible_cards() if cards is None else cards
    n_cards = max(len(cards), 1)
    on_card = len(range(index % n_cards, n_workers, n_cards))
    env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = \
        f"{CARD_MEMORY_SHARE / max(on_card, 1):.3f}"
    if len(cards) > 1:
        env["CUDA_VISIBLE_DEVICES"] = cards[index % n_cards]
    return env
