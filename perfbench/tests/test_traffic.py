"""The seeded schedule: the same seed gives the same requests; every seed
the same sizes and arrivals in another order."""

import json

import numpy as np

from perfbench import harness, traffic
from perfbench.tokenizer import Tokenizer
from perfbench.weights import synthetic_vocab

MIX = json.loads((harness.PKG / "workloads" / "open_mixed.json").read_text())
BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits


def test_same_seed_same_requests():
    a = traffic.schedule(MIX, 8.0, 50, BIG)
    b = traffic.schedule(MIX, 8.0, 50, BIG)
    assert a == b
    assert traffic.sample(a, BIG, MIX["check"]) == traffic.sample(b, BIG, MIX["check"])


def test_seeds_share_sizes_and_arrivals():
    a = traffic.schedule(MIX, 8.0, 50, BIG)
    b = traffic.schedule(MIX, 8.0, 50, BIG + 1)
    assert [r.due_s for r in a] != [r.due_s for r in b]
    assert sorted(r.n_predict for r in a) == sorted(r.n_predict for r in b)
    gaps = [np.diff([r.due_s for r in s] + [50.0]) for s in (a, b)]
    assert np.allclose(sorted(gaps[0]), sorted(gaps[1]))
    assert sum(r.stream for r in a) == sum(r.stream for r in b) == 200
    assert sum(r.greedy for r in a) == 50 and all(r.stream for r in a if r.greedy)


def test_counts_lengths_and_window():
    reqs = traffic.schedule(MIX, 8.0, 50, 7)
    assert len(reqs) == 400
    due = [r.due_s for r in reqs]
    assert due[0] == 0.0 and due == sorted(due) and due[-1] < 50
    n = np.array([r.n_predict for r in reqs])
    assert n.min() >= 50 and n.max() == 500 and abs(np.median(n) - 200) <= 1
    # about 15 characters a second of audio (25 codes a second)
    for r in reqs:
        assert 0.6 * r.n_predict - 2 <= len(r.text) <= 0.6 * r.n_predict + 12


def test_lognormal_quantiles_by_hand():
    # n = 1: the median; n = 2: median * exp(+-0.6 * z(0.75)), z(0.75) = 0.6745
    assert list(traffic.lognormal_quantiles(1, 200, 0.6, 50, 500)) == [200]
    lo, hi = traffic.lognormal_quantiles(2, 200, 0.6, 50, 500)
    assert (lo, hi) == (round(200 * np.exp(-0.6 * 0.67449)), round(200 * np.exp(0.6 * 0.67449)))


def test_sample_holds_the_longest():
    reqs = traffic.schedule(MIX, 8.0, 50, 11)
    smp = traffic.sample(reqs, 11, MIX["check"])
    for role, pool in (("llm", [r for r in reqs if r.greedy]),
                       ("wav", [r for r in reqs if not r.stream]),
                       ("stream", [r for r in reqs if r.stream])):
        assert len(smp[role]) == MIX["check"][role]
        assert max(r.n_predict for r in pool) == reqs[smp[role][0]].n_predict
        assert all(reqs[i] in pool for i in smp[role])


def test_context_holds_the_longest_request():
    """A prompt's tokens and its n_predict fit each configuration's --ctx-size."""
    for name in ("miotts-0.1b-wave24k", "miotts-0.1b-mel"):
        cfg = json.loads((harness.PKG / "configs" / f"{name}.json").read_text())
        flags = cfg["server_flags"]
        ctx = int(flags[flags.index("--ctx-size") + 1])
        tokens, types = synthetic_vocab(cfg["llm"]["n_audio"], cfg["llm"]["n_filler_vocab"])
        tok = Tokenizer(tokens, [], types)
        for seed in (1, BIG):
            for r in traffic.schedule(MIX, 10.0, 50, seed):
                assert len(tok.prompt_ids(r.text)) + r.n_predict <= ctx
