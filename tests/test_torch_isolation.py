"""The port stands alone: importing every repro_torch module pulls in
neither jax nor anything of the JAX package, and no source of the port
imports them, Triton or a package of finished kernels."""
import pathlib
import re
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro|triton|flash_attn|xformers|"
    r"apex|transformer_engine)(\.|\s|$)", re.MULTILINE)


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_modules())
    assert len(mods) >= 20
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.') or m == 'triton')\n"
              "print(bad)\n"
              "assert not bad, bad\n")
    src = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": src, "PATH": ""},
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_imports_jax_repro_or_kernel_packages():
    offenders = []
    for path in list(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]:
        for m in FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.name}: {m.group(0).strip()}")
    assert not offenders, offenders
