"""The port's host-edge primitives (`beatrice_vst_tpu_torch/native/`, over
`csrc/beatrice_host.cc` built with the host compiler at first use) against
the JAX package's: `SpscRing` and `Reblocker` bit-equal, `HostResampler`
within 1e-6 at 44.1->48, 48->16 and 16->48 kHz in odd block sizes, for the
port's native library and its NumPy versions (force_numpy=True); and a
failed build raises.

The JAX side runs its NumPy versions (force_numpy=True), which are the
same on any checkout, built native library or not."""

import os
import threading

import numpy as np
import pytest

from beatrice_vst_tpu.native import host as JH
from beatrice_vst_tpu_torch import cuda_build
from beatrice_vst_tpu_torch.native import host as PH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = [(44100, 48000), (48000, 16000), (16000, 48000)]
BLOCKS = (441, 137, 1000, 1, 77, 2048)


def _blocks(x):
    i = k = 0
    while i < len(x):
        n = BLOCKS[k % len(BLOCKS)]
        yield x[i:i + n]
        i += n
        k += 1


@pytest.mark.parametrize("force_numpy", [False, True])
@pytest.mark.parametrize("rates", RATES, ids=[f"{a}-{b}" for a, b in RATES])
def test_host_resampler_matches_the_jax_one(rates, force_numpy):
    rng = np.random.default_rng(sum(rates))
    x = rng.standard_normal(rates[0] // 2).astype(np.float32)  # 0.5 s
    port = PH.HostResampler(*rates, force_numpy=force_numpy)
    ref = JH.HostResampler(*rates, force_numpy=True)
    assert (port.L, port.M) == (ref.L, ref.M)
    for block in _blocks(x):
        got, want = port.process(block), ref.process(block)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_reblocker_bit_equal(force_numpy):
    port = PH.Reblocker(480, force_numpy=force_numpy)
    ref = JH.Reblocker(480, force_numpy=True)
    x = np.random.default_rng(1).standard_normal(20000).astype(np.float32)
    for block in _blocks(x):
        got, want = port.push(block), ref.push(block)
        assert got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_spsc_ring_bit_equal(force_numpy):
    """The same writes and reads, with the ring filling up (partial writes)
    and draining: the same counts and the same samples."""
    port = PH.SpscRing(1 << 10, force_numpy=force_numpy)
    ref = JH.SpscRing(1 << 10, force_numpy=True)
    rng = np.random.default_rng(2)
    for step in range(300):
        if step % 3:
            x = rng.standard_normal(int(rng.integers(0, 700))).astype(np.float32)
            assert port.write(x) == ref.write(x)
        else:
            n = int(rng.integers(0, 900))
            got, want = port.read(n), ref.read(n)
            assert got.shape == want.shape and np.array_equal(got, want)
        assert port.readable() == ref.readable()


def test_spsc_ring_threaded():
    ring = PH.SpscRing(1 << 12)
    n = 100_000
    src = np.arange(n, dtype=np.float32)
    got = []

    def producer():
        i = 0
        while i < n:
            i += ring.write(src[i:i + 1024])

    def consumer():
        total = 0
        while total < n:
            out = ring.read(1024)
            if len(out):
                got.append(out)
                total += len(out)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert np.array_equal(np.concatenate(got), src)


def test_ring_capacity_must_be_a_power_of_two():
    with pytest.raises(ValueError):
        PH.SpscRing(1000)


def test_library_builds_into_the_build_dir_not_native():
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    path = cuda_build.build_host(PH.LIBRARY)
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert path == cuda_build.host_library_path(PH.LIBRARY, cuda_build.host_compiler())
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
    assert PH.native_available()


def test_failed_build_raises(monkeypatch):
    """A compiler that fails (here `false`) raises, and so does every
    primitive that needs the library: nothing falls back to NumPy."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        cuda_build.build_host(PH.LIBRARY)
    for make in (lambda: PH.HostResampler(44100, 48000), lambda: PH.Reblocker(480),
                 lambda: PH.SpscRing(1 << 10)):
        with pytest.raises(RuntimeError):
            make()
    assert not PH.native_available()
    monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
    with pytest.raises(RuntimeError, match="not found"):
        PH.load_library()
