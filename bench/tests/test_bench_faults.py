"""A run with its timed path broken underneath comes out not correct.

Each test drives the whole of a run (``bench.run.execute``) on the CPU at
``.reduced()`` size, past the harness's look for a card, with one fault
planted in the program: a round whose KV state is never committed, half of
a batch's rows decoded and the rest given their logits, pages that come
back from the LMB tier zeroed (at this size the 8 onboard pages spill, so
the tier carries pages), a served token altered where it is produced.
Each must turn ``correct`` false.  (One chip holds the whole model, so
there is no exchange between chips to leave out.)"""

import torch

from bench.tests import small

CELL = "granite-34b.completion"


def _engine_hook(monkeypatch, patch):
    """Apply ``patch(engine)`` to the engine the run builds."""
    from bench import deploy
    build = deploy.build

    def built(*a, **kw):
        out = build(*a, **kw)
        patch(out[0])
        return out
    monkeypatch.setattr(deploy, "build", built)


def test_sound_run_is_correct():
    res = small.run(CELL, seed=6)
    assert res["correct"], res["check"]


def test_state_left_unchanged(monkeypatch):
    """commit_decode writes nothing back and advances nothing."""
    def patch(eng):
        eng.kv.commit_decode = lambda view, pool: None
    _engine_hook(monkeypatch, patch)
    res = small.run(CELL, seed=6)
    assert not res["correct"], res["check"]


def test_half_the_batch_left_out(monkeypatch):
    """The step decodes the first half of its rows; the rest take the
    first row's logits."""
    def patch(eng):
        step = eng._paged_fn

        def half(params, pool, tables, lengths, toks):
            B = toks.shape[0]
            if B < 2:
                return step(params, pool, tables, lengths, toks)
            h = B // 2
            logits, pool = step(params, pool, tables[:h], lengths[:h],
                                toks[:h])
            rest = logits[:1].expand(B - h, -1)
            return torch.cat([logits, rest]), pool
        eng._paged_fn = half
    _engine_hook(monkeypatch, patch)
    res = small.run(CELL, seed=6)
    assert not res["correct"], res["check"]


def test_pages_come_back_from_the_lmb_tier_zeroed(monkeypatch):
    from repro_torch.core.buffer import LinkedBuffer
    read = LinkedBuffer._read_runs

    def zeroed(self, *a, **kw):
        return [torch.zeros_like(x) for x in read(self, *a, **kw)]
    monkeypatch.setattr(LinkedBuffer, "_read_runs", zeroed)
    res = small.run(CELL, seed=6)
    assert not res["correct"], res["check"]


def test_a_token_altered_where_it_is_produced(monkeypatch):
    """Every third round, each row's logits point at another token."""
    def patch(eng):
        step, n = eng._paged_fn, [0]

        def altered(*args):
            logits, pool = step(*args)
            n[0] += 1
            if n[0] % 3 == 0:
                best = logits.argmax(dim=1, keepdim=True)
                logits = torch.zeros_like(logits).scatter_(
                    1, (best + 1 + n[0]) % logits.shape[1], 1.0)
            return logits, pool
        eng._paged_fn = altered
    _engine_hook(monkeypatch, patch)
    res = small.run(CELL, seed=6)
    assert not res["correct"], res["check"]
