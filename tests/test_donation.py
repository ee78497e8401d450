"""Buffer donation: the functional form of the reference's in-place API
(``src/fft.rs:494-554``). VERDICT r1 item 5: donation must be actually
wired (output aliases input; peak HBM ~halves at large n), not just
documented.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import kofft_tpu as kt
from kofft_tpu.ops.dft import snr_db


def test_fft_split_donate_matches_and_consumes(rng):
    n = 1 << 12
    x = rng.standard_normal((2, n)).astype(np.float32)
    z = rng.standard_normal((2, n)).astype(np.float32)
    ref_r, ref_i = kt.fft_split(jnp.asarray(x), jnp.asarray(z))
    xr = jnp.asarray(x)
    xi = jnp.asarray(z)
    with warnings.catch_warnings():
        # "donated buffer not usable" would surface here
        warnings.simplefilter("error")
        yr, yi = kt.fft_split(xr, xi, donate=True)
    assert snr_db(np.asarray(ref_r), np.asarray(yr)) > 120.0
    assert snr_db(np.asarray(ref_i), np.asarray(yi)) > 120.0
    # the donated inputs must actually have been consumed (aliased away)
    assert xr.is_deleted() and xi.is_deleted()


def test_donating_entry_lowers_with_aliasing():
    """The jitted donating entry carries buffer-donor/alias markers in its
    lowered module — i.e. XLA is told to reuse the input allocation, the
    mechanism that halves peak HBM at 2^22."""
    from kofft_tpu.ops.fft import _jitted_entry_pp
    f = _jitted_entry_pp(1 << 12, False, None, "xla", (), True)
    sds = jax.ShapeDtypeStruct((1 << 12,), jnp.float32)
    txt = f.lower(sds, sds).as_text()
    assert ("jax.buffer_donor" in txt) or ("tf.aliasing_output" in txt)


def test_donating_and_plain_entries_cached_separately():
    from kofft_tpu.ops.fft import _jitted_entry_pp
    a = _jitted_entry_pp(256, False, None, "xla", (), False)
    b = _jitted_entry_pp(256, False, None, "xla", (), True)
    assert a is not b


def test_ifft_split_donate_roundtrip(rng):
    n = 1 << 10
    x = rng.standard_normal(n).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    yr, yi = kt.fft_split(jnp.asarray(x), jnp.asarray(z))
    br, bi = kt.ifft_split(yr, yi, donate=True)
    assert yr.is_deleted() and yi.is_deleted()
    assert snr_db(x, np.asarray(br)) > 120.0
    assert snr_db(z, np.asarray(bi)) > 120.0


def test_real_device_array_never_donated_via_fallback(rng):
    """A REAL-valued jax.Array input to the eager fft() must survive the
    call: only host-numpy inputs (framework-owned uploads) may donate."""
    x = jnp.asarray(rng.standard_normal(256).astype(np.float32))
    y = kt.fft(x)
    assert not x.is_deleted(), "caller's array was donated away"
    ref = np.fft.fft(np.asarray(x).astype(np.complex128))
    assert snr_db(ref, np.asarray(y)) > 100.0
    # host numpy input still rides the donating entry and works
    xn = rng.standard_normal(256).astype(np.float32)
    y2 = kt.fft(xn)
    assert snr_db(np.fft.fft(xn.astype(np.complex128)),
                  np.asarray(y2)) > 100.0


def test_fft_split_tiled_donate(rng):
    """donate=True on the tiled pipeline entries consumes the input
    plane buffers (aliased into the outputs)."""
    import jax.numpy as jnp
    m, _ = kt.tiled_shape(1 << 14)
    ar = jnp.asarray(rng.standard_normal((m, m)).astype(np.float32))
    ai = jnp.asarray(rng.standard_normal((m, m)).astype(np.float32))
    ref = np.fft.fft(np.asarray(ar).reshape(m * m)
                     + 1j * np.asarray(ai).reshape(m * m))
    yr, yi = kt.fft_split_tiled(ar, ai, donate=True)
    got = (np.asarray(yr) + 1j * np.asarray(yi)).reshape(m * m)
    from kofft_tpu.ops.dft import snr_db
    assert snr_db(ref, got) > 90.0
    assert ar.is_deleted() and ai.is_deleted()
    br, bi = kt.ifft_split_tiled(yr, yi, donate=True)
    assert yr.is_deleted() and yi.is_deleted()
    assert np.asarray(br).shape == (m, m)
