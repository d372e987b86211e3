"""Port parity: ``repro_torch.data.pipeline`` is the reference's numpy
module copied as is: its text equals ``src/repro/data/pipeline.py``, and
``SyntheticTokens``, ``MemmapTokens`` and ``Prefetcher`` give byte-equal
arrays to the reference's. Plus the reference's own pipeline checks
(``tests/test_substrates.py``) on the port."""

from pathlib import Path

import numpy as np
import pytest

from repro.data import pipeline as r_pipe
from repro_torch.data import pipeline as p_pipe

ROOT = Path(__file__).resolve().parents[1]


def test_text_equals_the_reference():
    ref = (ROOT / "src" / "repro" / "data" / "pipeline.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "data" / "pipeline.py").read_text()
    assert port == ref


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (1, 1000)])
def test_synthetic_tokens_byte_equal(seed, step):
    kw = dict(vocab_size=151936, seq_len=64, global_batch=4, seed=seed)
    _equal(p_pipe.SyntheticTokens(**kw).batch(step),
           r_pipe.SyntheticTokens(**kw).batch(step))


def test_memmap_tokens_byte_equal(tmp_path):
    fp = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5 * 4 * 17).astype(
        np.uint16).tofile(fp)
    p = p_pipe.MemmapTokens(str(fp), seq_len=16, global_batch=4)
    r = r_pipe.MemmapTokens(str(fp), seq_len=16, global_batch=4)
    assert p.n_batches == r.n_batches == 5
    for step in (0, 3, 7):
        _equal(p.batch(step), r.batch(step))


def test_prefetcher_byte_equal():
    kw = dict(vocab_size=100, seq_len=8, global_batch=2)
    pf = p_pipe.Prefetcher(p_pipe.SyntheticTokens(**kw), depth=2,
                           start_step=5)
    rf = r_pipe.Prefetcher(r_pipe.SyntheticTokens(**kw), depth=2,
                           start_step=5)
    try:
        for _ in range(3):
            _equal(pf.get(), rf.get())
    finally:
        pf.close()
        rf.close()


def test_synthetic_deterministic_and_shifted():
    src = p_pipe.SyntheticTokens(vocab_size=1000, seq_len=16,
                                 global_batch=4, seed=7)
    b1, b2 = src.batch(3), src.batch(3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert not np.array_equal(src.batch(4)["tokens"], b1["tokens"])
