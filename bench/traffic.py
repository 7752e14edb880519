"""The one traffic generator: an offline batch queue, closed loop.

A traffic file fixes ``slots`` (the engine's batch lanes), ``streams``
(prompts a job hands the engine), ``prompt_len`` and ``gen_len``.  One
client submits job j + 1 when job j returns.  Job j's prompts are
``streams`` rows of ``prompt_len`` token ids drawn uniformly from the
vocabulary by numpy's PCG64 seeded with (seed, j): every seed gets the
same sizes, and the same seed the same ids.
"""

from __future__ import annotations

import numpy as np

WARMUP_JOB = -1          # the set-up's warm-up draws from its own stream


def _rng(seed: int, job: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, job % 2**32, 0x7AF1C])


def job_prompts(mix: dict, vocab: int, seed: int, job: int) -> np.ndarray:
    """(streams, prompt_len) int32 token ids of job ``job``."""
    return _rng(seed, job).integers(
        0, vocab, (mix["streams"], mix["prompt_len"])).astype(np.int32)


def warmup_prompts(mix: dict, vocab: int, seed: int) -> np.ndarray:
    """One wave's prompts, (slots, prompt_len): the warm-up's."""
    return job_prompts(mix, vocab, seed, WARMUP_JOB)[:mix["slots"]]


def sample(seed: int, n_jobs: int, streams: int, n: int) -> list:
    """``n`` (job, stream) pairs of the window, drawn from the seed, for
    the correctness check (all requests of a mix are equally long, so
    each holds the longest)."""
    total = n_jobs * streams
    picks = np.random.default_rng([seed % 2**64, 0xC4EC]).choice(
        total, size=min(n, total), replace=False)
    return [(int(p) // streams, int(p) % streams) for p in sorted(picks)]
