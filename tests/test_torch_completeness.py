"""The port does everything the reference package does, name for name.

An AST scan (nothing is imported) of every module under ``src/repro/``
lists its public top-level functions and classes and the public methods
of those classes; the port's module of the same path under
``src/repro_torch/`` must define each of them, unless the name is on
:data:`BY_DESIGN`, the reference's framework idiom that has no
counterpart in PyTorch, each with its reason. The list is held to what
is actually missing, so a name that gains a port counterpart leaves it.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF = SRC / "repro"
PORT = SRC / "repro_torch"

# (module path under the package, name): why the port has no counterpart.
BY_DESIGN = {
    ("models/modules.py", "split_keys"):
        "jax.random key splitting; the port draws from numpy generators",
    ("models/modules.py", "zeros_init"):
        "a jax.random initializer signature; the port allocates directly",
    ("models/modules.py", "stack_layer_params"):
        "stacks layers on a leading axis for lax.scan; the port keeps a "
        "list of layers",
    ("models/transformer.py", "aux_add"):
        "adds the scanned layers' aux pytrees; the port sums in its loop",
    ("models/transformer.py", "stack_init_caches"):
        "stacks per-layer caches for lax.scan; the port keeps a list",
    ("models/transformer.py", "stack_init_paged_caches"):
        "stacks per-layer paged caches for lax.scan; the port keeps a list",
    ("runtime/trainer.py", "Trainer.jitted_step"):
        "the jax.jit-compiled step; the port's step runs eagerly",
    ("parallel/sharding.py", "constrain"):
        "a GSPMD with_sharding_constraint hint; the manual SPMD places "
        "its collectives itself",
    ("parallel/sharding.py", "current_mesh"):
        "the ambient jax mesh context; the port passes its Mesh",
    ("parallel/sharding.py", "param_shardings"):
        "NamedShardings for jax.device_put; the port stores each rank's "
        "slices",
    ("parallel/sharding.py", "serve_mesh"):
        "builds a jax.sharding.Mesh over devices; the port's ranks are "
        "processes (launch/mesh.py)",
    ("parallel/sharding.py", "serve_param_shardings"):
        "NamedShardings of the serving params; the port stores each "
        "rank's slices",
    ("parallel/collectives.py", "parse_collective_bytes"):
        "parses collective bytes out of compiled HLO text; the port "
        "counts them as it calls them (collectives.stats)",
}

MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def public_names(path: pathlib.Path) -> set:
    """Public top-level functions and classes of a module, and the
    public methods of its classes as ``Class.method``."""
    names = set()
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, defs + (ast.ClassDef,)):
            continue
        if node.name.startswith("_"):
            continue
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names |= {f"{node.name}.{sub.name}" for sub in node.body
                      if isinstance(sub, defs)
                      and not sub.name.startswith("_")}
    return names


def test_the_scan_sees_the_reference():
    assert len(MODULES) > 40
    assert "core/sasa.py" in MODULES
    names = public_names(REF / "core/sasa.py")
    assert {"autotune_mlp_plan", "MlpPlan", "SparsityEMA.update"} <= names


@pytest.mark.parametrize("module", MODULES)
def test_port_module_defines_every_reference_name(module):
    port = PORT / module
    assert port.is_file(), f"src/repro_torch/{module} is missing"
    missing = public_names(REF / module) - public_names(port)
    lacking = sorted(n for n in missing if (module, n) not in BY_DESIGN)
    assert not lacking, (f"src/repro_torch/{module} lacks the reference's "
                         f"{lacking}")


@pytest.mark.parametrize("module,name", sorted(BY_DESIGN))
def test_by_design_names_are_still_missing(module, name):
    assert name in public_names(REF / module)
    assert name not in public_names(PORT / module), (
        f"{module}:{name} now has a port counterpart: take it off "
        "BY_DESIGN")
