"""The skewed graph generator: determinism, counts and degree statistics."""

import numpy as np

from kgbench.lib import kg, seeds

FB = dict(entities=14541, relations=237, train=272115, valid=17535,
          test=20466, exponent=0.6)


def test_same_seed_same_graph_and_seeds_differ():
    small = dict(FB, entities=500, train=4000, valid=300, test=300)
    a, b = kg.skewed_kg(small, 2**31 + 9), kg.skewed_kg(small, 2**31 + 9)
    c = kg.skewed_kg(small, 2**31 + 10)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(a[split], b[split])
    assert not np.array_equal(a["train"], c["train"])


def test_fb_counts_distinct_and_in_range():
    g = kg.skewed_kg(FB, 0)
    assert [len(g[k]) for k in ("train", "valid", "test")] == [
        272115, 17535, 20466]
    every = np.concatenate([g[k] for k in ("train", "valid", "test")])
    assert len(np.unique(every, axis=0)) == len(every)
    assert every[:, :2].max() < 14541 and every[:, 2].max() < 237
    assert every.min() >= 0


def test_fb_degree_statistics_at_seed_0():
    """Hub-dominated: the busiest entity about 5,400 edges, the median 27,
    the 99th percentile about 275 (a uniform graph's busiest has about
    60)."""
    deg = kg.degrees(kg.skewed_kg(FB, 0))
    assert 4800 <= deg.max() <= 6000
    assert np.median(deg) == 27
    assert 250 <= np.percentile(deg, 99) <= 300


def test_streams_are_independent_and_take_large_seeds():
    big = 2**33 + 5
    assert seeds.derive(big, "graph") != seeds.derive(big, "weights")
    assert seeds.derive(big, "graph", 1) != seeds.derive(big, "graph", 0)
    assert 0 <= seeds.derive(big, "engine") < 2**63
