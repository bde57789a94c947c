"""The port's data pipelines against the JAX package's.

``TokenPipeline`` draws from numpy's ``SeedSequence([seed, step, host_id])`` in both
packages, so its tokens are held bit for bit; the four properties of
tests/test_data.py are checked on the port. ``TelemetryPipeline`` draws with
``jax.random`` in the reference, so its transform is held on the reference's draws
(as test_torch_tpss.py holds ``synthesize_batch``).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import numpy as np

from repro.data import TelemetryPipeline as JTelemetryPipeline
from repro.data import TokenPipeline as JTokenPipeline
from repro_torch.data import TelemetryPipeline, TokenPipeline
from repro_torch.tpss import TPSSParams, synthesize_batch, synthesize_from_draws
from test_torch_tpss import ATOL, RTOL, _jax_draws, _jparams, _torch_draws

CPU = "cpu"


@pytest.mark.parametrize(
    "vocab,seq,batch,seed,step,n_hosts,host_id",
    [
        (1000, 32, 4, 3, 5, 1, 0),
        (512, 16, 2, 0, 0, 1, 0),  # seq_len + 1 > 12: the copy structure
        (50280, 64, 8, 7, 123, 2, 1),
        (256000, 12, 4, 1, 3, 4, 3),  # 13 tokens a row: the copy structure's edge
        (128, 8, 6, 2, 9, 3, 2),  # 9 tokens a row: no copy structure
        (1000, 128, 4, 11, 10**6, 1, 0),
    ],
)
def test_token_pipeline_equals_reference_bit_for_bit(
    vocab, seq, batch, seed, step, n_hosts, host_id
):
    kw = dict(seed=seed, n_hosts=n_hosts, host_id=host_id)
    got = TokenPipeline(vocab, seq, batch, device=CPU, **kw).batch(step)
    want = JTokenPipeline(vocab, seq, batch, **kw).batch(step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int64 and got[k].device.type == CPU
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_determinism_per_step():
    p = TokenPipeline(vocab_size=1000, seq_len=32, global_batch=4, seed=3, device=CPU)
    a, b, c = p.batch(5), p.batch(5), p.batch(6)
    np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"].numpy())
    assert not np.array_equal(a["tokens"].numpy(), c["tokens"].numpy())


def test_targets_are_shifted_tokens():
    b = TokenPipeline(vocab_size=1000, seq_len=16, global_batch=2, device=CPU).batch(0)
    assert b["tokens"].shape == (2, 16)
    assert b["targets"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:].numpy(), b["targets"][:, :-1].numpy())


def test_host_shards_are_disjoint_and_deterministic():
    full = [TokenPipeline(1000, 16, 8, seed=1, n_hosts=2, host_id=h, device=CPU) for h in (0, 1)]
    b0 = full[0].batch(3)["tokens"].numpy()
    b1 = full[1].batch(3)["tokens"].numpy()
    assert b0.shape == (4, 16)
    assert not np.array_equal(b0, b1)
    # re-instantiation reproduces the same shard
    again = TokenPipeline(1000, 16, 8, seed=1, n_hosts=2, host_id=0, device=CPU)
    np.testing.assert_array_equal(b0, again.batch(3)["tokens"].numpy())


def test_tokens_in_vocab_range():
    t = TokenPipeline(vocab_size=128, seq_len=64, global_batch=4, device=CPU).batch(0)["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 128


def test_hosts_must_divide_the_global_batch():
    with pytest.raises(ValueError, match="hosts"):
        TokenPipeline(1000, 16, 6, n_hosts=4, device=CPU)


@pytest.mark.parametrize("step", [0, 3])
def test_telemetry_window_transform_on_reference_draws(step):
    """The reference keys a window PRNGKey(seed + 7919 step) and splits it over the
    assets; the port's transform on those draws gives its window."""
    p = TPSSParams(n_signals=5, n_obs=160)
    ref = np.asarray(JTelemetryPipeline(_jparams(p), n_assets=3, seed=2).window(step))
    keys = jax.random.split(jax.random.PRNGKey(2 + step * 7919), 3)
    per_asset = [_jax_draws(k, p) for k in keys]
    stacked = {k: np.stack([d[k] for d in per_asset]) for k in per_asset[0]}
    out = synthesize_from_draws(_torch_draws(stacked), p).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_telemetry_window_is_the_ports_synthesis_at_the_reference_seed():
    p = TPSSParams(n_signals=4, n_obs=128)
    pipe = TelemetryPipeline(p, n_assets=2, seed=5, device=CPU)
    w = pipe.window(2)
    assert w.shape == (2, 128, 4) and w.device.type == CPU
    np.testing.assert_array_equal(w.numpy(), synthesize_batch(5 + 2 * 7919, p, 2, CPU).numpy())
    np.testing.assert_array_equal(w.numpy(), pipe.window(2).numpy())
    assert not np.array_equal(w.numpy(), pipe.window(3).numpy())
