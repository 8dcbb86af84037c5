"""The port's ``TokenPipeline`` (``repro_torch.data.pipeline``) against the
reference's (``repro.data.pipeline``), by bits, at P = 1 in process and at
P = 4 in a ``__main__`` subprocess (the reference needs its 4 host devices
before jax loads).

Both packages build the pipeline from the same seed: the corpus, its
on-disk dataset, the streamed dedup -> quality select -> length sort ->
rebalance. The surviving docs (``doc_id``, ``length``, ``content_hash``,
``quality`` in order), ``n_docs``, ``total_tokens``, the first three
``next()`` batches and the first ``epoch()`` batches must be equal by
bits, and the stages' properties must hold: distinct content hashes,
quality above the threshold, lengths non-decreasing, worker counts within
one. At P = 4 and 1500 docs, both packages' streamed dedup overflows its
per-batch static quota by the same 6 rows, and both refuse to run.
"""

import os
import sys

if __name__ == "__main__":  # the P=4 reference needs its devices before jax loads
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import subprocess  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import DDFContext as RefContext  # noqa: E402
from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro_torch.core import DDFContext  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_docs=3000, vocab=1000, seq_len=48, batch=4, seed=3, quality_threshold=0.2)
EPOCH_BATCHES = 6


def _bits(a: np.ndarray) -> bytes:
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint8).tobytes()


def check_against_reference(P: int) -> None:
    ref = RefPipeline(RefContext(mesh=jax.make_mesh((P,), ("data",)), axes=("data",)), **KW)
    port = TokenPipeline(DDFContext(nworkers=P, device="cpu"), **KW)
    got, exp = port.docs.to_numpy(), ref.docs.to_numpy()
    assert list(got) == list(exp) == ["content_hash", "doc_id", "length", "quality"]
    for k in exp:
        assert got[k].dtype == exp[k].dtype and _bits(got[k]) == _bits(exp[k]), (P, k)
    assert port.n_docs == ref.n_docs == len(exp["doc_id"])
    assert port.total_tokens == ref.total_tokens == int(exp["length"].sum())
    # the stages
    assert len(np.unique(got["content_hash"])) == port.n_docs
    assert (got["quality"] > KW["quality_threshold"]).all()
    assert (np.diff(got["length"]) >= 0).all()
    counts = port.docs.counts.numpy()
    assert counts.max() - counts.min() <= 1 and counts.sum() == port.n_docs
    assert port.stream_info["batches"] == ref.stream_info["batches"]
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys() and all(_bits(a[k]) == _bits(b[k]) for k in b)
        assert a["tokens"].shape == (KW["batch"], KW["seq_len"]) and a["tokens"].max() < KW["vocab"]
    pe, re_ = port.epoch(), ref.epoch()
    for _ in range(EPOCH_BATCHES):
        a, b = next(pe), next(re_)
        assert a.keys() == b.keys() and all(_bits(a[k]) == _bits(b[k]) for k in b), P


def check_same_overflow(P: int) -> None:
    """Both packages raise the same overflow where the reference's
    per-batch quota is too small (P = 4, 1500 docs)."""
    kw = {**KW, "n_docs": 1500}
    msgs = []
    for make in (lambda: RefPipeline(RefContext(mesh=jax.make_mesh((P,), ("data",)),
                                                axes=("data",)), **kw),
                 lambda: TokenPipeline(DDFContext(nworkers=P, device="cpu"), **kw)):
        try:
            make()
        except RuntimeError as e:
            msgs.append(str(e).split(" rows dropped")[0])
    assert len(msgs) == 2 and msgs[0] == msgs[1] and "overflow_agg': 6}" in msgs[0], msgs


def test_pipeline_matches_the_reference_at_p1():
    check_against_reference(1)


def test_pipeline_matches_the_reference_at_p4():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, os.path.abspath(__file__)], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "PIPELINE MATCHES REFERENCE AT P=4" in res.stdout


def test_pipeline_restarts_give_the_same_batches():
    """Two pipelines from one seed give the same batches; another seed
    gives others (the reference's restart check, on the port alone)."""
    ctx = DDFContext(nworkers=2, device="cpu")
    a, b = TokenPipeline(ctx, **KW), TokenPipeline(ctx, **KW)
    c = TokenPipeline(ctx, **{**KW, "seed": 4})
    x, y, z = next(a), next(b), next(c)
    assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(x["tokens"], z["tokens"])
    assert (x["labels"][:, :-1] == x["tokens"][:, 1:]).all()
    assert set(np.unique(x["loss_mask"])) <= {0.0, 1.0}


if __name__ == "__main__":
    assert len(jax.devices()) == 4, jax.devices()
    check_against_reference(4)
    check_same_overflow(4)
    print("PIPELINE MATCHES REFERENCE AT P=4")
