"""Routes the pipeline takes on a GPU, rehearsed on the CPU.

Every stage now takes the same route on every backend: the scanned ERI
sweep (f shells included), the integral-direct Fock build traced inside the
SCF while_loop, and the f64 CC while_loop.  Faking the platform name must
change nothing.  Also covered here: the compile-cache placement, the
tensor-parallel memory budget, `chip_smoke.py`'s contract off the card and
its multi-device phase on virtual CPU devices, and the bench's slope guard.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tuna_tpu.cli import run
from tuna_tpu.ops.integrals import IntegralPlan

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

# H has an f shell at cc-pVQZ: the smallest lmax = 3 system.
F_SHELL = (("H", "H"), 0.74, "CC-PVQZ")


def _fake_platform(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_eri_route_is_the_traced_scan(monkeypatch, platform):
    """At lmax = 3 the ERI is one scanned program on any platform: a plan
    built under either platform name traces inside an outer jit and matches
    the eager call bit for bit."""
    _fake_platform(monkeypatch, platform)
    molecule = chip_smoke._molecule(*F_SHELL)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = jnp.asarray(molecule.coordinates)
    assert plan.lmax == 3
    eager = np.asarray(plan.eri(coords))
    traced = np.asarray(jax.jit(lambda c: plan.eri(c) * 1.0)(coords))
    np.testing.assert_array_equal(eager, traced)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_direct_route_traces_the_sweep(monkeypatch, platform):
    """DIRECT at an f-shell basis traces the Fock sweep inside the SCF
    while_loop on any platform and reproduces the stored-tensor energy."""
    _fake_platform(monkeypatch, platform)
    stored = run("SPE : H H 0.74 : HF CC-PVQZ : TIGHTSCF",
                 suppress_output=True)[2]
    direct = run("SPE : H H 0.74 : HF CC-PVQZ : DIRECT TIGHTSCF",
                 suppress_output=True)[2]
    assert abs(stored - direct) < 1e-9, (stored, direct)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cc_route_is_the_f64_loop(monkeypatch, platform):
    """The CC driver solves with the f64 while_loop on any platform; the
    mixed-precision production solver is never reached."""
    import tuna_tpu.post.cc as cc

    _fake_platform(monkeypatch, platform)

    def refuse(settings):
        raise AssertionError("production solver reached from the driver")

    monkeypatch.setattr(cc, "get_production_solver", refuse)
    energy = run("SPE : N N 1.1 : CCSD STO-3G : TIGHTSCF",
                 suppress_output=True)[2]
    # this framework's CPU f64 value
    assert abs(energy - (-107.65019745467542)) < 1e-8, energy


def test_f_shell_eri_gradient_traces_under_jit():
    """jax.jit(jax.grad(...)) through plan.eri at lmax = 3 (the analytic
    gradient path of OPT/FREQ) agrees with a central difference."""
    molecule = chip_smoke._molecule(*F_SHELL)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)

    def f(R):
        coords = jnp.stack([jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]) * R])
        return jnp.sum(plan.eri(coords) ** 2)

    R, h = 1.4, 1e-4
    grad = float(jax.jit(jax.grad(f))(R))
    fd = (float(f(R + h)) - float(f(R - h))) / (2 * h)
    assert abs(grad - fd) <= 1e-6 * abs(fd), (grad, fd)


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, tuna_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_environment(tmp_path):
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)


def test_compile_cache_default_is_fixed_checkout_path():
    assert _cache_dir_in_fresh_process(None) == str(REPO / ".jax_cache")


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_hbm_budget_without_memory_stats(monkeypatch):
    """A device that reports no memory limit (the CPU) never auto-shards."""
    from tuna_tpu import parallel
    monkeypatch.delenv(parallel._HBM_BUDGET_ENV, raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(None)] * 8)
    assert parallel.tp_hbm_budget_bytes() == float("inf")
    assert parallel.auto_tp_mesh(1e15) is None


def test_hbm_budget_from_memory_stats(monkeypatch):
    from tuna_tpu import parallel
    monkeypatch.delenv(parallel._HBM_BUDGET_ENV, raising=False)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice({"bytes_limit": 60e9})])
    assert parallel.tp_hbm_budget_bytes() == 30e9


def test_hbm_budget_override(monkeypatch):
    from tuna_tpu import parallel
    monkeypatch.setenv(parallel._HBM_BUDGET_ENV, "1234")
    assert parallel.tp_hbm_budget_bytes() == 1234.0
    assert parallel.auto_tp_mesh(1e6) is not None     # 8 virtual devices
    assert parallel.auto_tp_mesh(1000.0) is None


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("got,ok", [
    (1.0 + 5e-9, True), (1.0 + 2e-8, False), (float("nan"), False)])
def test_chip_smoke_energy_comparison(got, ok):
    if ok:
        chip_smoke.check_close("e", got, 1.0, chip_smoke.ENERGY_TOL_HA)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_close("e", got, 1.0, chip_smoke.ENERGY_TOL_HA)


def test_chip_smoke_eri_parity_phase_runs_on_host():
    """The ERI parity phase's plumbing (card side vs a CPU-pinned plan) at a
    small f-free basis; on the CPU both sides are the host."""
    chip_smoke.eri_parity_phase("CC-PVDZ")


def test_chip_smoke_residual_parity_phase_runs_on_host():
    chip_smoke.residual_parity_phase("STO-3G")


def test_chip_smoke_four_card_phase_on_virtual_devices():
    """The --four phase at a small basis on four virtual CPU devices (N2/
    cc-pVDZ has 28 MOs, so the MO-tensor sharding check is exercised)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = ("import chip_smoke, tuna_tpu; "
            "chip_smoke.four_card_phase('CC-PVDZ'); print('FOUR OK')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUR OK" in out.stdout
    assert "on 4 devices" in out.stdout


def test_bench_slope_guard():
    assert bench.slope_per_iteration([]) is None
    assert bench.slope_per_iteration([3e-3, 1e-3, 2e-3]) == 1e-3


@pytest.mark.gpu
def test_eri_matches_host_on_gpu(gpu_device):
    """On the card: the f-shell ERI matches the CPU-pinned plan to 1e-12."""
    molecule = chip_smoke._molecule(*F_SHELL)
    coords = np.asarray(molecule.coordinates)
    bfs = molecule.cartesian_basis_functions
    with jax.default_device(gpu_device):
        card = np.asarray(IntegralPlan(bfs, 2).eri(coords))
    with jax.default_device(jax.devices("cpu")[0]):
        host = np.asarray(IntegralPlan(bfs, 2).eri(coords))
    assert np.max(np.abs(card - host)) <= 1e-12

