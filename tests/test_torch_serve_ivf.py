"""The port's serve launcher with int8 storage and IVF search, on the CPU
at a few hundred rows: the summary lines in the JAX launcher's words, the
searches answered through the refresher's index, the final flush, and the
int8 server against the JAX server on one stream.

Tolerances as tests/test_torch_serve.py: served rows atol 1e-5, tables
atol 1e-5 (int8 dequantized).
"""
import numpy as np
import pytest

from repro.core import KnowledgeBankServer as JaxServer
from repro_torch.core.async_runtime import KnowledgeBankServer
from repro_torch.launch import serve

N, D = 64, 16
LAZY_LR, ZMAX = 0.2, 2.0


@pytest.mark.parametrize("storage", ["int8", "fp32"])
def test_serve_ivf_on_the_cpu(capsys, storage):
    res = serve.main(["--kb", "--device", "cpu", "--kb-entries", "300",
                      "--kb-dim", "16", "--clients", "4", "--batch", "3",
                      "--gen", "3", "--kb-storage", storage,
                      "--kb-search", "ivf", "--nlist", "8", "--nprobe",
                      "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("kb-serve backend=cuda search=ivf "
                             "coalesce=True clients=4: ")
    assert "nn ivf/exact=" in out[0] and "index rebuilds=" in out[0]
    bpr = 16 + 8 if storage == "int8" else 64
    assert out[1].startswith(f"kb storage mode={storage} bytes/row={bpr} "
                             "resident=300/300")
    assert out[2].startswith("ivf buckets: cap=")
    # every search ran after the first build and went through the index
    # (coalesced searches count once)
    assert res["search_stats"]["exact"] == 0
    assert 1 < res["search_stats"]["ivf"] <= 4 * 3 + 1
    assert res["index_rebuilds"] >= 1 and res["first_index_s"] > 0
    assert res["requests"] == 4 * 3 * 3 + 3    # + fill, warm search, flush
    st = res["engine"].state
    assert not st.grad_cnt.any() and not st.grad_sum.any()   # flushed


def test_int8_server_matches_jax_server():
    """The same serial stream through both packages' int8 servers."""
    port = KnowledgeBankServer(N, D, lazy_lr=LAZY_LR, zmax=ZMAX,
                               storage="int8", coalesce=False, device="cpu")
    ref = JaxServer(N, D, lazy_lr=LAZY_LR, zmax=ZMAX, storage="int8",
                    coalesce=False)
    rng = np.random.default_rng(5)
    table = (0.5 * rng.standard_normal((N, D))).astype(np.float32)
    for srv in (port, ref):
        srv.update(np.arange(N), table)
    for _ in range(6):
        ids = rng.integers(0, N, 5)
        g = (0.1 * rng.standard_normal((5, D))).astype(np.float32)
        for srv in (port, ref):
            srv.lazy_grad(ids, g)
        np.testing.assert_allclose(port.lookup(ids), ref.lookup(ids),
                                   atol=1e-5)
    q = rng.standard_normal((3, D)).astype(np.float32)
    (ps, pi), (rs, ri) = port.nn_search(q, 4), ref.nn_search(q, 4)
    np.testing.assert_allclose(ps, rs, atol=1e-5)
    np.testing.assert_array_equal(pi, ri)
    port.flush()
    ref.flush()
    np.testing.assert_allclose(port.table_snapshot(), ref.table_snapshot(),
                               atol=1e-5)
    assert port.stats()["storage"] == ref.stats()["storage"]
    assert port.metrics["dispatches"] == ref.metrics["dispatches"]
    port.close()
    ref.close()
