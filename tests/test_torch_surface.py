"""The port's public surface against the JAX package's, read from both
packages' sources with `ast` (neither package is imported).

Every public name of `sppark_tpu` must have a counterpart in
`sppark_tpu_torch`, or an entry of JAX_INTERNAL that says why it has
none:

  * a top-level def, class or assignment of a JAX module M is a top-level
    name of one of M's targets: the port module of the same path, or the
    modules MAPPING lists for M;
  * a method of a top-level class C of M (a def in its body or in a JAX
    base class's, which JAX_INTERNAL and RENAMED name by the class that
    defines it) is a method of the port's class C (or of a base class of
    it in its module) where a target holds a class C; where none does, a
    target defines it as a method of any class or as a module function;
    RENAMED names the port's name where it differs.

Class attributes and dataclass fields are not compared.  Where a JAX
module has `__all__`, the port's module of the same path has one holding
each of its names but the JAX_INTERNAL ones.  Each entry of JAX_INTERNAL,
RENAMED and MAPPING must still name something in the JAX package, and the
targets of RENAMED and MAPPING something in the port.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "sppark_tpu"
PORT = ROOT / "sppark_tpu_torch"

#: where the port keeps each family of fields' ops
FIELD_MODULES = ("ff/bigmont.py", "ff/mont32.py", "ff/lane.py", "ff/ext.py",
                 "ff/gl64.py")

#: JAX module -> the port modules that hold its names, where the port has
#: no module of the same path or keeps them elsewhere
MAPPING = {
    "ec/pallas_ops.py": ("ec/kernels.py",),
    "ntt/pallas_kernels.py": ("ntt/kernels.py", "ntt/fused.py"),
    "ff/base.py": FIELD_MODULES,
}

#: "module:Name" or "module:Class.method" of the JAX package -> why the
#: port has no counterpart
JAX_INTERNAL = {
    "ff/__init__.py:get_jax_field":
        "the JAX field factory; the port's are get_field_ops, "
        "get_mont32_ops, get_fp2_ops and ff/lane.py:get_base_ops",
    "ff/base.py:barrier":
        "an XLA optimization barrier; PyTorch runs eagerly",
    "ff/base.py:BaseField":
        "the JAX fields' base class; its methods are held in the port's "
        "field modules (MAPPING)",
    "ff/gl64.py:GoldilocksField":
        "the port's Goldilocks is ff/gl64.py's module functions on int64 "
        "words; its methods are held there",
    "ff/gl64.py:GoldilocksField.to_mont":
        "Goldilocks words are canonical: no Montgomery form",
    "ff/gl64.py:GoldilocksField.from_mont":
        "Goldilocks words are canonical: no Montgomery form",
    "ff/bigmont.py:add_limbs":
        "a limb helper of the JAX 16-bit limb planes",
    "ff/bigmont.py:cond_sub_p":
        "a limb helper of the JAX 16-bit limb planes",
    "ff/bigmont.py:mul_limbs":
        "a limb helper of the JAX 16-bit limb planes",
    "ff/bigmont.py:norm_limbs":
        "a limb helper of the JAX 16-bit limb planes",
    "ff/bigmont.py:sqr_limbs":
        "a limb helper of the JAX 16-bit limb planes",
    "ff/bigmont.py:sub_limbs_mod":
        "a limb helper of the JAX 16-bit limb planes",
    "ff/bigmont.py:sub_p_limbs":
        "a limb helper of the JAX 16-bit limb planes",
    "ff/mont32.py:Mont32Field.redc":
        "the JAX u32 reduction from two 32-bit halves; the port widens "
        "the product to int64",
    "ff/mont32.py:mul32_wide":
        "the JAX 32x32 -> 64-bit product from 16-bit halves; the port "
        "widens to int64",
    "ff/mont32.py:mulhi32":
        "the JAX high half of a 32x32 product; the port widens to int64",
    "ec/core.py:tree_take":
        "a JAX pytree helper; a port point is a tuple of tensors",
    "ec/core.py:tree_concat":
        "a JAX pytree helper; a port point is a tuple of tensors",
    "ec/pallas_ops.py:use_fused_madd":
        "the JAX switch between Pallas and XLA point ops; the port's "
        "wrappers pick the kernel by the tensor's device",
    "ec/pallas_ops.py:fused_xyzz_add":
        "a Pallas facade; the port's is ec/kernels.py:xyzz_add",
    "ec/pallas_ops.py:fused_xyzz_dbl":
        "a Pallas facade; the port's is ec/kernels.py:xyzz_dbl",
    "ec/pallas_ops.py:fused_xyzz_madd":
        "a Pallas facade; the port's is ec/kernels.py:xyzz_madd",
    "ec/pallas_ops.py:fused_affine_pair":
        "a Pallas facade; the port's is msm/tree.py:affine_pair_add",
    "ntt/pallas_kernels.py:ntt_fused":
        "a Pallas facade; the port's is ntt/fused.py:facade",
    "ntt/pallas_kernels.py:fused_facade_fn":
        "a jitted Pallas facade; the port's is ntt/fused.py:facade",
    "ntt/pallas_kernels.py:use_fused":
        "the JAX switch between Pallas and XLA NTTs; the port always "
        "takes the kernels' path",
    "msm/pippenger.py:MSMStages":
        "the JAX stages' base class; the port's stages are MSMSlabStages, "
        "MSMTreeStages and MSMRoundStages",
    "msm/slab.py:make_slab_gather":
        "a jitted JAX stage; the port gathers through msm/slab.py:"
        "slot_index",
    "msm/slab.py:make_slab_accumulate":
        "a jitted JAX stage; the port's is msm/slab.py:accumulate",
    "msm/tree.py:make_tree_accumulate":
        "a jitted JAX stage; the port's is msm/tree.py:accumulate",
    "ntt/parameters.py:NTTParameters.stage_twiddles":
        "per-stage tables of the JAX XLA NTT; the port's stages slice "
        "power_table",
    "ntt/parameters.py:NTTParameters.staged_table":
        "per-stage tables of the JAX XLA NTT; the port's stages slice "
        "power_table",
    "ntt/parameters.py:NTTParameters.staged_full_table":
        "per-stage tables of the JAX XLA NTT; the port's stages slice "
        "power_table",
    "parallel/mesh.py:AXIS":
        "the axis name of a jax.sharding.Mesh; a torch.distributed group "
        "has none",
}

#: "module:Class.method" of the JAX package -> "module:name" of the port
RENAMED = {
    "ff/gl64.py:GoldilocksField.from_int_list": "ff/gl64.py:from_ints",
    "ff/gl64.py:GoldilocksField.to_int_list": "ff/gl64.py:to_ints",
    "ff/gl64.py:GoldilocksField.from_wire_np": "ff/gl64.py:from_wire",
    "ff/gl64.py:GoldilocksField.to_wire_np": "ff/gl64.py:to_wire",
}


def _read(pkg: pathlib.Path) -> dict:
    """{module path: {"top": {name: class methods or None}, "bases":
    {class: [base names]}, "all": [names] or None}} of a package."""
    out = {}
    for path in sorted(pkg.rglob("*.py")):
        top, bases, exported = {}, {}, None
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                top[node.name] = None
            elif isinstance(node, ast.ClassDef):
                top[node.name] = {n.name for n in node.body if isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef))}
                bases[node.name] = [b.id for b in node.bases
                                    if isinstance(b, ast.Name)]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            top[n.id] = None
                            if n.id == "__all__":
                                exported = ast.literal_eval(node.value)
        out[path.relative_to(pkg).as_posix()] = {
            "top": top, "bases": bases, "all": exported}
    return out


@pytest.fixture(scope="module")
def both():
    return _read(JAX), _read(PORT)


def _class_methods(mod: dict, cls: str) -> set:
    """A class's methods with those of its bases in the same module."""
    names, todo = set(), [cls]
    while todo:
        c = todo.pop()
        names |= mod["top"].get(c) or set()
        todo += mod["bases"].get(c, [])
    return names


def _targets(rel: str, port: dict) -> list:
    mods = ([rel] if rel in port else []) + list(MAPPING.get(rel, ()))
    return [port[m] for m in mods]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _jax_methods(jax: dict, rel: str, cls: str) -> dict:
    """{method: "module:Class" that defines it} of a JAX class, its JAX
    base classes' (found by name anywhere in the package) included."""
    found = {}
    for base in jax[rel]["bases"].get(cls, []):
        for r, mod in jax.items():
            if mod["top"].get(base) is not None:
                found.update(_jax_methods(jax, r, base))
                break
    found.update({m: f"{rel}:{cls}" for m in jax[rel]["top"][cls]})
    return found


def _missing(jax: dict, port: dict) -> list:
    missing = []
    for rel, mod in jax.items():
        targets = _targets(rel, port)
        for name, methods in mod["top"].items():
            if not _public(name):
                continue
            if f"{rel}:{name}" not in JAX_INTERNAL and not any(
                    name in t["top"] for t in targets):
                missing.append(f"{rel}:{name}")
            if methods is None:
                continue
            owners = [t for t in targets if t["top"].get(name) is not None]
            for m, owner in sorted(_jax_methods(jax, rel, name).items()):
                if not _public(m) or f"{owner}.{m}" in JAX_INTERNAL or \
                        f"{owner}.{m}" in RENAMED:
                    continue
                if owners:
                    found = any(m in _class_methods(t, name) for t in owners)
                else:
                    found = any(m in t["top"] or any(
                        m in (ms or ()) for ms in t["top"].values())
                        for t in targets)
                if not found:
                    missing.append(f"{rel}:{name}.{m}")
    return missing


def test_every_public_name_has_a_counterpart(both):
    jax, port = both
    assert _missing(jax, port) == []


def test_exports_hold_the_jax_exports(both):
    """Each JAX `__all__` name is in the same port module's `__all__`."""
    jax, port = both
    internal = {k.split(":")[1] for k in JAX_INTERNAL}
    modules = [rel for rel, mod in jax.items() if mod["all"] is not None]
    assert {"__init__.py", "ntt/__init__.py", "runtime/__init__.py",
            "util/__init__.py", "parallel/__init__.py",
            "polynomial/__init__.py"} <= set(modules)
    for rel in modules:
        have = set(port[rel]["all"] or ())
        want = set(jax[rel]["all"]) - internal
        assert want <= have, (rel, sorted(want - have))


def test_tables_name_what_exists(both):
    """No entry outlives what it names."""
    jax, port = both

    def exists(pkg: dict, key: str) -> bool:
        rel, name = key.split(":")
        mod = pkg.get(rel)
        if mod is None:
            return False
        cls, _, meth = name.partition(".")
        if not meth:
            return cls in mod["top"]
        return meth in (mod["top"].get(cls) or ())

    for key, reason in JAX_INTERNAL.items():
        assert reason.strip(), key
        assert exists(jax, key), key
    for key, new in RENAMED.items():
        assert exists(jax, key) and exists(port, new), (key, new)
    for rel, mods in MAPPING.items():
        assert rel in jax, rel
        assert all(m in port for m in mods), (rel, mods)


def test_the_walk_sees_a_missing_name(both):
    """The check fails on a port without one of its names."""
    jax, port = both
    cut = {rel: dict(mod, top=dict(mod["top"])) for rel, mod in port.items()}
    ops = cut["ec/core.py"]["top"]
    ops["CurveOps"] = ops["CurveOps"] - {"affine_cneg"}
    del cut["ntt/core.py"]["top"]["ntt_nn"]
    assert _missing(jax, cut) == ["ec/core.py:CurveOps.affine_cneg",
                                  "ntt/core.py:ntt_nn"]
