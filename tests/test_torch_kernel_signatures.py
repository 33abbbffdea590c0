"""The C entry points of the port's CUDA kernels against the ``ctypes``
argument types the flash wrapper declares for them, on the CPU.

A kernel library has a plain C interface and ``ctypes`` passes each
argument as ``_SIGNATURES`` says: a pointer declared as an int, or an int
declared as a float, shows only on the card, as a cut pointer or a
garbage shape. So every ``extern "C" int name(...)`` in
``ray_tpu_torch/ops/csrc/*.cu`` is parsed here and held against its row,
and every kernel variant of ``_LIBRARIES`` must name entry points that
exist.
"""

import importlib
import re
from pathlib import Path

import pytest

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

CSRC = Path(fa.__file__).resolve().parent / "csrc"
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _ctype(param: str):
    """The ``ctypes`` type a C parameter is passed as."""
    param = " ".join(param.split())
    if "*" in param:
        return fa._VP
    kind = param.split()[-2]
    return {"int": fa._CI, "float": fa._CF}[kind]


def _entry_points():
    """{(library, function): [ctypes type per parameter]} of every
    ``extern "C"`` function of every kernel source."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(path.read_text()):
            found[(path.stem, name)] = [_ctype(p) for p in params.split(",")]
    return found


ENTRY_POINTS = _entry_points()


def test_every_kernel_source_has_entry_points():
    assert {lib for lib, _ in ENTRY_POINTS} == {
        p.stem for p in CSRC.glob("*.cu")}


@pytest.mark.parametrize("key", sorted(ENTRY_POINTS),
                         ids=lambda k: f"{k[0]}.{k[1]}")
def test_entry_point_matches_its_signature_row(key):
    """Pointer, int and float arguments in the C function's count and
    order."""
    assert key in fa._SIGNATURES, f"{key} has no _SIGNATURES row"
    assert fa._SIGNATURES[key] == ENTRY_POINTS[key]


@pytest.mark.parametrize("key", sorted(fa._SIGNATURES),
                         ids=lambda k: f"{k[0]}.{k[1]}")
def test_signature_row_names_an_entry_point(key):
    assert key in ENTRY_POINTS, f"no extern \"C\" {key[1]} in {key[0]}.cu"


def _param_names(library, function):
    params = re.search(
        r'extern\s+"C"\s+int\s+' + function + r'\s*\(([^)]*)\)',
        (CSRC / f"{library}.cu").read_text(), re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in params.split(",")]


@pytest.mark.parametrize("variant", sorted(fa._LIBRARIES))
def test_variant_names_entry_points_that_exist(variant):
    """The forward, dQ and dK/dV entry points of a variant (every variant
    has all three), each in the variant's own libraries; a dK/dV kernel of
    ``_READS_DELTA`` takes delta and no O, the others O and no delta."""
    fwd_lib, bwd_lib, suffix = fa._LIBRARIES[variant]
    assert fwd_lib is not None
    assert (fwd_lib, "flash_attention_fwd" + suffix) in ENTRY_POINTS
    dkv = (bwd_lib, "flash_attention_bwd_dkv" + suffix)
    assert dkv in ENTRY_POINTS
    assert (bwd_lib, "flash_attention_bwd_dq" + suffix) in ENTRY_POINTS
    names = _param_names(*dkv)
    reads_delta = variant in fa._READS_DELTA
    assert ("delta" in names) == reads_delta
    assert ("o" in names) == (not reads_delta)


@pytest.mark.parametrize("variant", sorted(fa._LIBRARIES))
def test_variant_dq_entry_point_takes_delta(variant):
    """Every variant's dQ entry point exists in its own backward library
    and takes O and dO; it takes a delta buffer wherever its dK/dV kernel
    reads delta, and so do all the wide ones ("wide"'s takes null). Only
    the earlier f32 CUDA-core pair up to 256 ("simt"'s, which the rule
    no longer reaches) computes delta in both kernels and passes none."""
    _, bwd_lib, suffix = fa._LIBRARIES[variant]
    key = (bwd_lib, "flash_attention_bwd_dq" + suffix)
    assert key in ENTRY_POINTS and key in fa._SIGNATURES
    names = _param_names(*key)
    assert "o" in names and "dout" in names
    assert ("delta" in names) == (variant != "simt")
    if variant in fa._READS_DELTA:
        assert "delta" in names


def test_every_backward_variant_of_the_rule_names_its_entry_points():
    """Each variant ``_forward_variant`` (the rule of the forward and the
    backward alike) can return, at every head_dim that is a multiple of 8
    up to 2048 in each dtype, is in ``_LIBRARIES`` with its dQ and dK/dV
    entry points: f32 up to 256 the ``"tiled_f32"`` pair, never
    ``"simt"``'s; bf16 and f16 above 256 the tensor-core wide kernels,
    never ``"wide"``'s."""
    import torch

    seen = {fa._forward_variant(dtype, D)
            for dtype in (torch.float32, torch.bfloat16, torch.float16)
            for D in range(8, 2049, 8)}
    assert seen == {"tiled_f32", "wgmma", "wide_f32", "wide_wgmma"}
    for variant in seen:
        _, bwd_lib, suffix = fa._LIBRARIES[variant]
        for kind in ("dq", "dkv"):
            assert (bwd_lib, f"flash_attention_bwd_{kind}{suffix}") \
                in ENTRY_POINTS


@pytest.mark.parametrize("variant", sorted(fa._LIBRARIES))
def test_variant_counts_its_forward_launches_under_its_name(variant):
    """``_launch`` counts each variant's forward launches in its own
    counter (``<variant>_launches``), under a branch of its own: no
    variant is counted as another's, and an unknown one raises."""
    import inspect

    counter = f"{variant}_launches"
    assert getattr(fa, counter) >= 0
    source = inspect.getsource(fa._launch)
    assert re.search(r'variant == "' + variant + r'":\n\s+' + counter
                     + r" \+= 1", source), variant
    assert "raise RuntimeError" in source.split(counter)[-1]


@pytest.mark.parametrize("variant", sorted(fa._LIBRARIES))
def test_variant_counts_its_backward_launches_under_its_name(variant):
    """``_launch_dq`` and ``_launch_dkv`` count each variant's launches
    in its own counters (``dq_<variant>_launches``, ``dkv_<…>``), each
    under a branch of its own: no variant is counted as another's."""
    import inspect

    for kind, fn in (("dq", fa._launch_dq), ("dkv", fa._launch_dkv)):
        counter = f"{kind}_{variant}_launches"
        assert getattr(fa, counter) >= 0
        source = inspect.getsource(fn)
        assert re.search(r'variant == "' + variant + r'":\n\s+' + counter
                         + r" \+= 1", source), (kind, variant)
        assert "raise RuntimeError" in source.split(counter)[-1]


@pytest.mark.parametrize("variant", ["wide", "simt"])
def test_earlier_variant_is_reached_by_no_rule_but_keeps_its_kernels(
        variant):
    """No dtype at any head_dim that is a multiple of 8 up to 8192 routes
    to the earlier CUDA-core kernels (``"wide"`` above 256, ``"simt"`` up
    to it), on the forward's rule or the route rule; each keeps its three
    C entry points in ``_SIGNATURES`` and in its source, which chip_smoke.py
    calls by name as the baseline."""
    import torch

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in range(8, 8193, 8):
            assert fa._forward_variant(dtype, D) != variant, (dtype, D)
            assert fa._attention_route(dtype, D, 64, 64) != variant
    fwd_lib, bwd_lib, suffix = fa._LIBRARIES[variant]
    for lib, name in ((fwd_lib, "flash_attention_fwd" + suffix),
                      (bwd_lib, "flash_attention_bwd_dq" + suffix),
                      (bwd_lib, "flash_attention_bwd_dkv" + suffix)):
        assert (lib, name) in fa._SIGNATURES
        assert (lib, name) in ENTRY_POINTS
