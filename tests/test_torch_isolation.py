"""The port stands alone: no module of src/repro_torch, nor chip_smoke.py,
imports jax or anything of the JAX package ``repro`` — checked by importing
every module in a fresh interpreter and by scanning the sources' imports."""
import ast
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_modules() -> list:
    mods = []
    for dirpath, _, names in os.walk(PORT):
        for name in sorted(names):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name),
                                  os.path.join(ROOT, "src"))
            mod = rel[:-3].replace(os.sep, ".")
            mods.append(mod[:-len(".__init__")]
                        if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_the_port_pulls_in_no_jax():
    mods = _port_modules()
    assert "repro_torch.core.transform" in mods and len(mods) > 20
    assert "repro_torch.models.rwkv" in mods
    # the mesh slice's modules are scanned and imported too
    for m in ("repro_torch.launch.mesh", "repro_torch.core.collectives",
              "repro_torch.core.buckets"):
        assert m in mods, m
    code = textwrap.dedent(f"""
        import importlib.util, json, sys
        sys.path.insert(0, {os.path.join(ROOT, "src")!r})
        for m in {mods!r}:
            importlib.import_module(m)
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      {SMOKE!r})
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)      # a module: main() does not run
        print(json.dumps(sorted(sys.modules)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []
    assert "repro_torch.core.transform" in loaded


def test_sources_import_no_jax():
    files = [os.path.join(d, n) for d, _, ns in os.walk(PORT) for n in ns
             if n.endswith(".py")] + [SMOKE]
    offenders = []
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path}:{node.lineno}: {n}" for n in names
                          if _forbidden(n)]
    assert offenders == []
