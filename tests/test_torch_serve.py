"""The port's serving loop against the reference's, on the CPU.

The 12 requests of ``examples/serve_batch.py`` go through the reference's
``BatchServer`` and the port's at f32 from the same parameters: every
request's token stream, ``requests_done``, ``tokens_generated`` and
``decode_steps`` must be identical. EDF admission and ``_merge_slot`` are
held against the reference's, including the ``batch_slots=1`` quirk (equal
cache shapes leave the batch cache unchanged). The same workload also
goes through a MoE (qwen3-moe-smoke, whose capacity, and so what it
drops, differs between a prefill and a decode step in both packages alike)
and an MLA (minicpm3-smoke: rank-3 latent and RoPE-key cache leaves) smoke
server, with identical token streams.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import model_spec as j_model_spec  # noqa: E402
from repro.runtime import serve_loop as j_serve  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def setup():
    j_cfg = j_get_smoke_config(ARCH).scaled(dtype=jnp.float32)
    t_cfg = get_smoke_config(ARCH).scaled(dtype=torch.float32)
    params = j_init_params(jax.random.PRNGKey(0), j_model_spec(j_cfg))
    return j_cfg, t_cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _requests(module, vocab, n=12, max_new=12):
    # the workload of examples/serve_batch.py
    rng = np.random.default_rng(0)
    return [
        module.Request(
            id=i,
            prompt=rng.integers(0, vocab, size=int(rng.integers(4, 24))).astype(np.int32),
            max_new_tokens=max_new,
            deadline=float(rng.integers(1, 100)),
        )
        for i in range(n)
    ]


@pytest.mark.parametrize("slots,n,max_new", [(4, 12, 12), (1, 3, 5)], ids=["serve_batch", "one_slot"])
def test_token_streams_match_reference(setup, slots, n, max_new):
    j_cfg, t_cfg, j_params, t_params = setup
    j_server = j_serve.BatchServer(j_cfg, j_params, batch_slots=slots, max_seq=128)
    t_server = serve_loop.BatchServer(t_cfg, t_params, batch_slots=slots, max_seq=128, device="cpu")
    j_reqs = _requests(j_serve, j_cfg.vocab, n, max_new)
    t_reqs = _requests(serve_loop, t_cfg.vocab, n, max_new)
    for a, b in zip(j_reqs, t_reqs):
        j_server.submit(a)
        t_server.submit(b)
    jm, tm = j_server.run(), t_server.run()
    assert [r.tokens_out for r in t_reqs] == [r.tokens_out for r in j_reqs]
    assert (tm.requests_done, tm.tokens_generated, tm.decode_steps) == (
        jm.requests_done, jm.tokens_generated, jm.decode_steps)
    assert tm.requests_done == n


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "minicpm3-4b"])
def test_moe_and_mla_token_streams_match_reference(arch):
    j_cfg = j_get_smoke_config(arch).scaled(dtype=jnp.float32)
    t_cfg = get_smoke_config(arch).scaled(dtype=torch.float32)
    params = j_init_params(jax.random.PRNGKey(0), j_model_spec(j_cfg))
    t_params = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    j_server = j_serve.BatchServer(j_cfg, params, batch_slots=4, max_seq=128)
    t_server = serve_loop.BatchServer(t_cfg, t_params, batch_slots=4, max_seq=128, device="cpu")
    j_reqs, t_reqs = _requests(j_serve, j_cfg.vocab), _requests(serve_loop, t_cfg.vocab)
    for a, b in zip(j_reqs, t_reqs):
        j_server.submit(a)
        t_server.submit(b)
    jm, tm = j_server.run(), t_server.run()
    assert [r.tokens_out for r in t_reqs] == [r.tokens_out for r in j_reqs]
    assert (tm.requests_done, tm.tokens_generated, tm.decode_steps) == (
        jm.requests_done, jm.tokens_generated, jm.decode_steps) == (12, 132, jm.decode_steps)


# ---------------------------------------------------------------------------
# EDF admission
# ---------------------------------------------------------------------------


def _req(module, rid, deadline):
    return module.Request(id=rid, prompt=np.zeros((4,), np.int32), deadline=deadline)


def test_admission_edf_with_fifo_ties():
    q = serve_loop.AdmissionQueue()
    for rid, dl in ((1, 30.0), (2, 10.0), (3, float("inf")), (4, 20.0), (5, 10.0)):
        q.push(_req(serve_loop, rid, dl))
    assert [q.pop().id for _ in range(len(q))] == [2, 5, 4, 1, 3]
    assert len(q) == 0 and not q


def test_admission_order_matches_reference():
    rng = np.random.default_rng(11)
    ours, theirs = serve_loop.AdmissionQueue(), j_serve.AdmissionQueue()
    popped_ours, popped_theirs = [], []
    for rid in range(200):
        dl = float(rng.integers(0, 8)) if rng.random() < 0.9 else float("inf")
        ours.push(_req(serve_loop, rid, dl))
        theirs.push(_req(j_serve, rid, dl))
        if rng.random() < 0.3:
            popped_ours.append(ours.pop().id)
            popped_theirs.append(theirs.pop().id)
    popped_ours += [ours.pop().id for _ in range(len(ours))]
    popped_theirs += [theirs.pop().id for _ in range(len(theirs))]
    assert popped_ours == popped_theirs


# ---------------------------------------------------------------------------
# _merge_slot
# ---------------------------------------------------------------------------


def _trees(slots=4, seq=8):
    batch = {
        "attn": np.arange(2 * slots * seq * 3, dtype=np.float32).reshape(2, slots, seq, 3),
        "ssm": np.ones((2, slots, 5), np.float32),
        "step": np.zeros((2,), np.int32),
    }
    one = {
        "attn": -np.ones((2, 1, seq, 3), np.float32),
        "ssm": 7.0 * np.ones((2, 1, 5), np.float32),
        "step": np.ones((2,), np.int32),
    }
    return batch, one


@pytest.mark.parametrize("slot", [0, 2, 3, 9])
def test_merge_slot_matches_reference(slot):
    batch, one = _trees()
    want = j_serve._merge_slot({k: jnp.asarray(v) for k, v in batch.items()},
                               {k: jnp.asarray(v) for k, v in one.items()}, slot)
    t_batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    got = serve_loop._merge_slot(t_batch, {k: torch.from_numpy(v) for k, v in one.items()}, slot)
    for key in batch:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        assert got[key] is t_batch[key]  # written in place
    np.testing.assert_array_equal(got["step"].numpy(), batch["step"])  # equal shapes: unchanged


def test_merge_slot_one_slot_quirk():
    # batch_slots=1: the two caches have equal shapes and the batch cache is
    # left as it was, as in the reference (the prefilled cache is dropped)
    batch = {"layers": {"k": torch.zeros(2, 1, 8, 2, 4)}}
    one = {"layers": {"k": torch.ones(2, 1, 8, 2, 4)}}
    got = serve_loop._merge_slot(batch, one, 0)
    assert torch.count_nonzero(got["layers"]["k"]) == 0
    want = j_serve._merge_slot({"layers": {"k": jnp.zeros((2, 1, 8, 2, 4))}},
                               {"layers": {"k": jnp.ones((2, 1, 8, 2, 4))}}, 0)
    assert int(jnp.count_nonzero(want["layers"]["k"])) == 0
