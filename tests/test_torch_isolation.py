"""shadow_tpu_torch stands alone: no module of the port, nor chip_smoke.py,
imports jax or anything of the reference package shadow_tpu (the card
machine has no JAX), and the port runs with both made unimportable."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "shadow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "shadow_tpu")


def _imported(path):
    """Every absolute module name a file imports (any nesting level)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.append(node.args[0].value)
    return out


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_mesh_plane():
    """The parallel/ modules (the mesh data plane) are among the files
    scanned above."""
    names = {str(f.relative_to(ROOT)) for f in FILES}
    assert {"shadow_tpu_torch/parallel/__init__.py",
            "shadow_tpu_torch/parallel/mesh.py"} <= names


def test_scan_covers_the_transport_slice():
    """The device transport's modules, the kernel's module and the web and
    DNS models are among the files scanned above."""
    names = {str(f.relative_to(ROOT)) for f in FILES}
    assert {"shadow_tpu_torch/network/devtransport.py",
            "shadow_tpu_torch/ops/transport_kernels.py",
            "shadow_tpu_torch/models/web.py",
            "shadow_tpu_torch/models/dns.py",
            "shadow_tpu_torch/convert.py"} <= names


def _c_strings(path):
    """Every string literal of a C source (comments stripped first)."""
    text = re.sub(r"/\*.*?\*/|//[^\n]*", "", path.read_text(), flags=re.S)
    return re.findall(r'"((?:[^"\\\n]|\\.)*)"', text)


C_FILES = sorted((ROOT / "shadow_tpu_torch" / "csrc").glob("*.c"))


@pytest.mark.parametrize("path", C_FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_c_sources_name_no_reference_module(path):
    """The C engine imports modules by name at run time: none of its
    string literals may name a module of the reference package."""
    strings = _c_strings(path)
    assert "shadow_tpu_torch.network.colplane" in strings
    bad = [s for s in strings if re.search(r"\bshadow_tpu\.", s)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_c_string_scan_sees_a_reference_module(tmp_path):
    src = tmp_path / "x.c"
    src.write_text('/* "shadow_tpu.a" */ f("shadow_tpu.network.x", "y\\"");')
    assert _c_strings(src) == ["shadow_tpu.network.x", 'y\\"']
    assert C_FILES, "no C source under shadow_tpu_torch/csrc"


def test_scan_sees_forbidden_imports():
    """The scan itself: it flags what it must and passes the port."""
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("shadow_tpu") and _forbidden("shadow_tpu.ops.prng")
    assert not _forbidden("shadow_tpu_torch.ops.prng")


def test_port_runs_with_jax_and_reference_blocked(tmp_path):
    """The default path, the C engine built from the port's own copy
    attached: nothing of jax or the reference is imported, the engine's
    own module lookup included."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['shadow_tpu'] = None\n"
        "from shadow_tpu_torch.cli import main\n"
        f"rc = main(['examples/echo.yaml', '--scheduler-policy', "
        f"'tpu_batch', '--device', 'cpu', '--set', "
        f"'experimental.tpu_device_floor=1', '--data-directory', "
        f"{str(tmp_path / 'd')!r}, '--quiet'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'shadow_tpu.'))"
        " for m, v in sys.modules.items() if v is not None), 'leak'\n"
        "assert 'shadow_tpu_torch.native._colcore' in sys.modules\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert (tmp_path / "d" / "hosts" / "client" / "client.log").exists()


def test_port_runs_tpu_mesh_with_jax_and_reference_blocked(tmp_path):
    """The tpu_mesh path (network/devroute.py -> parallel/mesh.py) with
    every window through the exchange, jax and the reference unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['shadow_tpu'] = None\n"
        "from shadow_tpu_torch.cli import main\n"
        f"rc = main(['examples/echo.yaml', '--scheduler-policy', "
        f"'tpu_mesh', '--device', 'cpu', '--set', "
        f"'experimental.tpu_mesh_floor=0', '--data-directory', "
        f"{str(tmp_path / 'd')!r}, '--quiet'])\n"
        "import shadow_tpu_torch.parallel.mesh\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'shadow_tpu.'))"
        " for m, v in sys.modules.items() if v is not None), 'leak'\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert (tmp_path / "d" / "hosts" / "client" / "client.log").exists()


def test_port_runs_device_transport_with_jax_and_reference_blocked(tmp_path):
    """The device-transport path (network/devtransport.py ->
    ops/transport_kernels.py) on the web and DNS models, every cohort
    through the device path, jax and the reference unimportable."""
    from tests.test_torch_transport import WEB_CFG

    cfg = tmp_path / "web.yaml"
    cfg.write_text(WEB_CFG)
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['shadow_tpu'] = None\n"
        "from shadow_tpu_torch.cli import main\n"
        "from shadow_tpu_torch.network import devtransport\n"
        "devtransport._DEVICE_FLOOR = 1\n"
        f"rc = main([{str(cfg)!r}, '--scheduler-policy', 'tpu_batch', "
        f"'--device', 'cpu', '--set', 'experimental.device_transport=true', "
        f"'--set', 'experimental.native_colcore=false', "
        f"'--stop-time', '4s', '--data-directory', "
        f"{str(tmp_path / 'd')!r}, '--quiet', '--json-summary'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'shadow_tpu.'))"
        " for m, v in sys.modules.items() if v is not None), 'leak'\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    import json

    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["process_errors"] == []
    assert summary["device_transport"]["cohorts"] > 0
