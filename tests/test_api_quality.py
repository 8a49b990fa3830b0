"""Static-quality gate — the Aqua.test_all analog (reference
test/runtests.jl:36: method ambiguities, undefined exports, stale deps).

Python equivalents: every public name in __all__ must resolve; every module
must import cleanly and compile; the package must not leak obviously-private
modules into the public namespace; docstrings exist on public API.
"""

import compileall
import importlib
import inspect
import pathlib
import pkgutil

import quasinewtonmethods_jl_tpu as qnm

PKG_DIR = pathlib.Path(qnm.__file__).parent


def _walk_modules():
    for info in pkgutil.walk_packages([str(PKG_DIR)], prefix="quasinewtonmethods_jl_tpu."):
        yield info.name


def test_all_modules_import():
    for name in _walk_modules():
        importlib.import_module(name)


def test_all_sources_compile():
    assert compileall.compile_dir(str(PKG_DIR), quiet=2, force=True)


def test_public_names_resolve():
    for name in qnm.__all__:
        assert hasattr(qnm, name), f"__all__ lists missing name {name!r}"
    for sub in ("models", "ops", "parallel", "utils"):
        mod = importlib.import_module(f"quasinewtonmethods_jl_tpu.{sub}")
        for name in mod.__all__:
            assert hasattr(mod, name), f"{sub}.__all__ lists missing {name!r}"


def test_public_api_documented():
    for name in qnm.__all__:
        obj = getattr(qnm, name)
        if callable(obj) and not isinstance(obj, type):
            assert inspect.getdoc(obj), f"{name} lacks a docstring"


def test_version_is_semver():
    parts = qnm.__version__.split(".")
    assert len(parts) == 3 and all(p.isdigit() for p in parts)


def test_version_single_sourced():
    """__version__ must equal pyproject.toml's (the reference keeps ONE
    version in Project.toml; round-3 shipped 0.3.0 vs 0.4.0 skew)."""
    import re

    pyproject = (PKG_DIR.parent / "pyproject.toml").read_text()
    m = re.search(r'^version\s*=\s*"([^"]+)"', pyproject, re.MULTILINE)
    assert m, "pyproject.toml lacks a version"
    assert qnm.__version__ == m.group(1)


def test_status_enum_complete():
    # every driver exit path has a status code
    names = {s.name for s in qnm.Status}
    assert names == {
        "RUNNING",
        "CONVERGED",
        "MAX_ITERATIONS",
        "LINESEARCH_FAILURE",
        "NONFINITE_VALUE",
    }


def test_public_api_is_documented():
    """Docs-completeness gate (the Documenter-autodocs analog): every name
    exported from the package root must appear in docs/api.md."""
    api_md = (PKG_DIR.parent / "docs" / "api.md").read_text()
    missing = [name for name in qnm.__all__ if name not in api_md]
    assert not missing, f"undocumented public names: {missing}"


def test_documented_api_exists():
    """Reverse docs gate: every ``### `qnm.X(...)``` / ``### `parallel.X```
    / ``### `ops.X``` heading in docs/api.md must resolve to a real
    attribute — the Documenter-autodocs guarantee that docs cannot claim a
    symbol that does not exist (round 3 shipped a documented-but-unexported
    `optimize_batched_resident`; reference docs/make.jl + ci.yml:68-89
    structurally prevent this)."""
    import re

    api_md = (PKG_DIR.parent / "docs" / "api.md").read_text()
    headings = re.findall(r"^### `([^`]+)`", api_md, re.MULTILINE)
    unresolved = []
    for h in headings:
        # each heading may pack several symbols: "qnm.a(...)` / `qnm.b"
        for sym in re.findall(r"(?:qnm|parallel|ops)\.[\w.]+", h):
            root_name, _, path = sym.partition(".")
            obj = (
                qnm
                if root_name == "qnm"
                else importlib.import_module(
                    f"quasinewtonmethods_jl_tpu.{root_name}"
                )
            )
            try:
                for part in path.split("."):
                    obj = getattr(obj, part)
            except AttributeError:
                unresolved.append(sym)
    assert not unresolved, f"api.md documents missing symbols: {unresolved}"
