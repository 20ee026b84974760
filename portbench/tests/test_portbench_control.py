"""The comparison that decides ``correct`` fails where it must: the controls
(the reference in bfloat16 in the program's place) and runs whose timed
path is broken underneath, each driven through the whole harness on the
CPU with its look for a card skipped. A sound run comes out correct."""

import numpy as np
import pytest

import run
from yardstick import control, gen, judge, reference as R


def test_build_control_is_not_correct(tiny):
    cell = tiny("wt10g.build")
    cfg = cell.config
    # bfloat16 rounds counts above 256: use a collection that has some
    cfg.update(num_docs=1200, vocab_size=512)
    ptr, terms = gen.collection(cfg, cfg["num_docs"], 7)
    nums = control.build_numbers(ptr, terms, cfg["vocab_size"])
    assert nums["pairs_wrong"] > 0 and not judge.verdict(nums)


def test_serve_control_is_not_correct(tiny):
    cell = tiny("wt10g-dfdesc.serve-zipf")
    cfg = cell.config
    ptr, terms = gen.collection(cfg, cfg["serve_docs"], 7)
    post = R.Postings(ptr, terms, cfg["vocab_size"])
    q = gen.zipf_term_sampler(post.df, 1.0)(np.random.default_rng(1), 200)
    ids, scores = control.topk_answers(post, q, 10)
    nums = judge.judge_topk(post, q, ids, scores, 10)
    assert not judge.verdict(nums), nums


def test_sound_build_run_is_correct(tiny):
    out = run.run_cell(tiny("wt10g.build"), 2**31 + 11, 0.5, True, "cpu")
    assert out["correct"], out["numbers"]
    assert out["ctx"]["jobs"][0]["pair_occurrences"] > 0


def test_sound_build_run_at_the_published_vocabulary_is_correct(tiny):
    """The reference, the store's reading and the comparison at the
    configuration's own 5.75M term ids, on a few short documents."""
    cell = tiny("wt10g.build")
    cell.config.update(num_docs=24, mean_len=40.0, vocab_size=5_750_000)
    cell.mix.update(jobs=2)
    out = run.run_cell(cell, 2**33 + 5, 0.0, False, "cpu")
    assert out["correct"] and out["attempted"] == 1, out["numbers"]
    assert out["numbers"]["pairs_wrong"] == 0


def _wrap_count(monkeypatch, fn):
    from repro_torch.core import cooc

    real = cooc.count_to_store
    monkeypatch.setattr(cooc, "count_to_store", lambda m, c, p, **kw: fn(real, m, c, p, kw))


BUILD_FAULTS = {
    # the job returns the state it found: nothing committed
    "state unchanged": lambda real, m, c, p, kw: None,
    # half of the batch left out
    "half the documents": lambda real, m, c, p, kw: real(m, c.head(c.num_docs // 2), p, **kw),
}


@pytest.mark.parametrize("fault", sorted(BUILD_FAULTS))
def test_broken_build_is_not_correct(tiny, monkeypatch, fault):
    _wrap_count(monkeypatch, BUILD_FAULTS[fault])
    out = run.run_cell(tiny("wt10g.build"), 21, 0.0, False, "cpu")
    assert not out["correct"], out["numbers"]


def test_build_with_an_altered_count_is_not_correct(tiny, monkeypatch):
    """A count altered where the merge produces it."""
    from repro_torch.store import builder

    real = builder.merge_bucket_runs

    def altered(*a, **kw):
        rows = real(*a, **kw)
        primary, secs, cnts = next(rows)
        yield primary, secs, cnts + np.eye(1, len(cnts), dtype=cnts.dtype)[0]
        yield from rows

    monkeypatch.setattr(builder, "merge_bucket_runs", altered)
    out = run.run_cell(tiny("wt10g.build"), 22, 0.0, False, "cpu")
    assert not out["correct"] and out["numbers"]["pairs_wrong"] > 0


def _wrap_topk(monkeypatch, fn):
    from repro_torch.store.serving import CoocClient

    real = CoocClient.topk
    monkeypatch.setattr(CoocClient, "topk",
                        lambda self, terms, *a, **kw: fn(real, self, np.asarray(terms), a, kw))


def _first_id_altered(real, self, terms, a, kw):
    ids, sc = real(self, terms, *a, **kw)
    ids = ids.copy()
    ids[0, 0] = (ids[0, 0] + 1) % 4096
    return ids, sc


def _half_batch(real, self, terms, a, kw):
    h = len(terms) // 2
    ids, sc = real(self, terms[:h], *a, **kw)
    return np.concatenate([ids, ids[:len(terms) - h]]), np.concatenate([sc, sc[:len(terms) - h]])


def _never_answers(real, self, terms, a, kw):
    ids, sc = real(self, terms, *a, **kw)
    if self._client_id == 0:
        raise TimeoutError("no answer")
    return ids, sc


SERVE_FAULTS = {"answer altered": _first_id_altered, "half the batch": _half_batch,
                "answer never comes": _never_answers}


@pytest.mark.parametrize("fault", [None] + sorted(SERVE_FAULTS))
def test_serving_run_is_correct_only_when_sound(tiny, monkeypatch, fault):
    if fault:
        _wrap_topk(monkeypatch, SERVE_FAULTS[fault])
    out = run.run_cell(tiny("wt10g-dfdesc.serve-zipf"), 3_000_000_007, 6.0, True, "cpu")
    assert out["correct"] == (fault is None), out["numbers"]
    if fault is None:
        metrics = run.metrics_of(tiny("wt10g-dfdesc.serve-zipf"), out, True)
        assert {"serve_execute_ms", "serve_queue_wait_ms", "row_cache_hit_pct",
                "topk_p95_ms"} <= set(metrics)
