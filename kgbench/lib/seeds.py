"""Independent streams from one run seed: every draw of a run (graph,
requests, weights, engine) takes its own stream, so that the same seed
gives the same inputs and one stream's length never moves another's."""

import numpy as np

STREAMS = {"graph": 1, "requests": 2, "weights": 3, "engine": 4,
           "sample": 5}


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for ``stream`` (and its ``index``-th member) of run
    ``seed`` (any whole number >= 0)."""
    ss = np.random.SeedSequence(int(seed), spawn_key=(STREAMS[stream],
                                                       int(index)))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream, index))
