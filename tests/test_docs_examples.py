"""Executed documentation — nothing in README/examples may silently rot.

The reference runs `doctest(QuasiNewtonMethods)` as a dedicated CI job
(/root/reference/.github/workflows/ci.yml:68-89) and its README doubles as
an executable acceptance test (README.md:59-75 has literal @test lines).
The analog here: every ```python block in README.md is extracted and
executed (the quick-start block contains its own asserts — the exact
reference-parity bars), and each examples/*.py script runs end-to-end on
the CPU backend.
"""

import pathlib
import re
import runpy
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _python_blocks(md_path):
    text = md_path.read_text()
    return re.findall(r"```python\n(.*?)```", text, re.DOTALL)


README_BLOCKS = _python_blocks(ROOT / "README.md")


def test_readme_has_executable_blocks():
    assert len(README_BLOCKS) >= 1


def test_readme_python_blocks_execute_in_order():
    """The README's ```python blocks form one executable session (like the
    reference's doctests): run them in order in a shared namespace. The
    quick-start block asserts the reference README's exact quality bars
    (/root/reference/README.md:59-75)."""
    ns = {"__name__": "readme_session"}
    for i, code in enumerate(README_BLOCKS):
        exec(compile(code, f"README.md#block{i}", "exec"), ns)


@pytest.mark.parametrize(
    "script",
    sorted(p.name for p in (ROOT / "examples").glob("*.py")),
)
def test_example_runs(script):
    """Every example script must execute end-to-end (CPU backend, the
    sizes in the scripts are chosen to stay test-friendly)."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script)],
        capture_output=True,
        text=True,
        timeout=600,
        env={
            "PYTHONPATH": str(ROOT),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "PATH": "/usr/local/bin:/usr/bin:/bin",
            "HOME": "/tmp",
        },
    )
    assert proc.returncode == 0, (
        f"{script} failed\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}"
    )


def test_bench_sharded_runs_virtual_mesh():
    """The multi-device DP scaling harness measures accelerators only: as a
    script on the CPU it must refuse (non-zero exit, no JSON rows). Its
    timing function itself still runs on the virtual CPU mesh, so the
    sharded fleet call it times stays covered without a GPU."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_sharded.py"),
         "--per-device", "8", "--n", "6", "--reps", "1"],
        capture_output=True,
        text=True,
        timeout=600,
        env={
            "PYTHONPATH": str(ROOT),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "PATH": "/usr/local/bin:/usr/bin:/bin",
            "HOME": "/tmp",
        },
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no accelerator" in proc.stderr

    sys.path.insert(0, str(ROOT))
    try:
        import bench_sharded
    finally:
        sys.path.remove(str(ROOT))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from quasinewtonmethods_jl_tpu.parallel import make_mesh

    for k in (1, 2, 4):
        mesh = make_mesh({"data": k}, devices=jax.devices()[:k])
        X = jnp.asarray(
            np.random.default_rng(k).standard_normal((8 * k, 6)), jnp.float32
        )
        assert bench_sharded.time_fleet(mesh, X, reps=1) > 0
