"""The port's C interface and SmaQ launch plan, checked without a card.

``ops/cuda/build.py`` loads ``csrc/*.cu`` with ``ctypes``; an argument
declared with the wrong type (a pointer as a 32-bit int, a 32-bit call
index as a pointer) is cut or misread without any error on the CPU, and
only a chip run would show it.  So every ``extern "C"`` entry point's C
signature is parsed here and held against the ``argtypes`` that
``build._declare`` sets on a stand-in library; every stochastic kernel
takes its step key by pointer and its call index by value, and every
elementwise kernel its element dtype.  ``smaq_plan`` (with its one-launch
bfloat16 form and that form's capacity) and ``s2fp8_plan``, the bfloat16
``float_quantize`` launch shape, and the launch constants and workspace
layouts that the wrappers and ``csrc/smaq.cu``, ``csrc/float_quantize.cu``
or ``csrc/s2fp8.cu`` both state, are pinned too.
"""

import ctypes
import math
import re

import pytest
import torch

from smart_quantization_tpu_torch.ops.cuda import build
from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
from smart_quantization_tpu_torch.ops.cuda.float_kernel import (
    BF16_LOAD_ELEMS,
    format_args,
    launch_blocks,
)
from smart_quantization_tpu_torch.ops.cuda.launch import (
    BLOCKS_PER_SM,
    DTYPES,
    THREADS,
    quant_blocks,
    split_blocks,
)
from smart_quantization_tpu_torch.ops.float_format import FP8_FORMAT

_SCALARS = {
    "int": ctypes.c_int,
    "unsigned int": ctypes.c_uint,
    "long long": ctypes.c_longlong,
    "unsigned long long": ctypes.c_ulonglong,
    "float": ctypes.c_float,
}


def _ctype(param: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split() if w != "const"][:-1]  # drop the name
    return _SCALARS[" ".join(words)]


def _read(path):
    with open(path) as f:
        return f.read()


def _signatures() -> dict[str, list[str]]:
    """Each entry point's parameter declarations."""
    out = {}
    for src in build.sources():
        if src.endswith(".cu"):
            text = _read(src)
            c_block = text[text.index('extern "C" {'):]
            for m in re.finditer(r"^int\s+(\w+)\(([^)]*)\)\s*\{", c_block, re.M):
                out[m.group(1)] = [" ".join(a.split()) for a in m.group(2).split(",")]
    return out


SIGNATURES = _signatures()
ENTRY_POINTS = {name: [_ctype(a) for a in params] for name, params in SIGNATURES.items()}


class _Library:
    """Takes ``build._declare``'s attribute writes as ``ctypes.CDLL`` would."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def _declared() -> dict:
    lib = _Library()
    build._declare(lib)
    return vars(lib)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_ctypes_declaration_matches_c_signature(name):
    fn = _declared().get(name)
    assert fn is not None, f"{name} has no ctypes declaration"
    assert fn.restype is ctypes.c_int
    want = ENTRY_POINTS[name]
    assert len(fn.argtypes) == len(want), f"{name}: {len(fn.argtypes)} argtypes for {len(want)} parameters"
    for k, (got, c) in enumerate(zip(fn.argtypes, want)):
        assert got is c, f"{name} argument {k}: declared {got.__name__}, the C side needs {c.__name__}"


def test_every_declaration_has_an_entry_point():
    assert {"smaq_stats", "smaq_quantize", "smaq_quantize_bn", "smaq_onepass",
            "smaq_onepass_smem", "smaq_occupancy", "float_quantize", "float_occupancy",
            "s2fp8_stats", "s2fp8_quantize", "s2fp8_stats_table", "s2fp8_quantize_window",
            "s2fp8_occupancy", "philox_fill"} <= set(ENTRY_POINTS)
    assert set(_declared()) == set(ENTRY_POINTS)


@pytest.mark.parametrize(
    "name", ["smaq_quantize", "smaq_quantize_bn", "smaq_onepass", "float_quantize",
             "s2fp8_quantize", "s2fp8_quantize_window", "philox_fill"])
def test_stochastic_kernels_read_their_key_from_device_memory(name):
    """A CUDA graph bakes a launch's arguments: the key goes by pointer
    (each replay reads the slot the host wrote) and the call index by value,
    one after the other; no 64-bit seed is passed by value any more."""
    params = SIGNATURES[name]
    i = params.index("const unsigned long long* key")
    assert params[i + 1] == "unsigned int call"
    assert not any(p.endswith(" seed") for p in params)


@pytest.mark.parametrize(
    "name", ["smaq_quantize", "smaq_quantize_bn", "smaq_onepass", "float_quantize",
             "s2fp8_quantize", "s2fp8_quantize_window", "philox_fill"])
def test_stochastic_kernels_take_an_element_offset(name):
    """Every stochastic kernel counts its Philox words from the element
    offset of its tensor in a larger one (csrc/philox.cuh: Draws), a 64-bit
    value after the call index, and picks its instance by that offset."""
    params = SIGNATURES[name]
    i = params.index("unsigned int call")
    assert params[i + 1] == "long long offset"
    src = _read(f"{build.CSRC}/{_SOURCES[name]}")
    assert "smaq::draws(key, call, offset)" in src and "smaq::has_offset(offset)" in src


_SOURCES = {"smaq_quantize": "smaq.cu", "smaq_quantize_bn": "smaq.cu", "smaq_onepass": "smaq.cu",
            "float_quantize": "float_quantize.cu", "s2fp8_quantize": "s2fp8.cu",
            "s2fp8_quantize_window": "s2fp8.cu", "philox_fill": "philox_fill.cu"}


@pytest.mark.parametrize(
    "name", ["smaq_stats", "smaq_quantize", "smaq_quantize_bn", "smaq_onepass",
             "float_quantize", "s2fp8_stats", "s2fp8_quantize"])
def test_elementwise_kernels_take_the_element_dtype(name):
    """Each elementwise kernel reads and writes float32 or bfloat16
    elements: x (and y) untyped, then n, then the ``int dtype`` the wrappers
    pass as ``launch.DTYPES`` gives it (csrc/elem.cuh)."""
    params = SIGNATURES[name]
    i = params.index("long long n")
    assert params[i + 1] == "int dtype"
    assert params[0] == "const void* x" and (i == 1 or params[1] == "void* y")
    assert DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    src = _read(f"{build.CSRC}/smaq.cu")
    assert "constexpr int kFloat32 = 0, kBFloat16 = 1;" in src


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM and PCIe
@pytest.mark.parametrize(
    "n", [10, K.SMALL_MAX - 1, K.SMALL_MAX, K.SMALL_MAX + 1, 300_001, 8_388_608]
)
def test_smaq_plan(n, sms):
    """Small tensors take the one-block form; the split form spreads over
    the card with no more blocks than fit on it at once (BLOCKS_PER_SM of
    THREADS on each SM) and than the workspace holds partials for."""
    form, blocks = K.smaq_plan(n, sms)
    if n <= K.SMALL_MAX:
        assert (form, blocks) == ("small", 1)
        assert K.SMALL_THREADS <= 1024
        return
    assert form == "split"
    assert blocks == min(sms * K.BLOCKS_PER_SM, math.ceil(n / (4 * THREADS)))
    assert K.BLOCKS_PER_SM * THREADS <= 2048  # threads resident per SM
    assert K._COUNTER_WORDS + 4 * blocks <= K.workspace_words(sms)


@pytest.mark.parametrize(
    "c_name, value",
    [("kThreads", THREADS), ("kMinBlocks", K.BLOCKS_PER_SM),
     ("kSmallThreads", K.SMALL_THREADS), ("kCounterWords", K._COUNTER_WORDS),
     ("kGiven", K._GIVEN), ("kConsts", K._CONSTS), ("kSmall", K._SMALL),
     ("kSlotBytes", K.SLOT_BYTES)],
)
def test_launch_constants_match_smaq_cu(c_name, value):
    src = _read(f"{build.CSRC}/smaq.cu")
    m = re.search(rf"\b{c_name} = (\d+)", src)
    assert m is not None and int(m.group(1)) == value


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM and PCIe
@pytest.mark.parametrize(
    "n", [10, S.SMALL_MAX - 1, S.SMALL_MAX, S.SMALL_MAX + 1, 300_001, 8_388_608]
)
def test_s2fp8_plan(n, sms):
    """S2FP8 takes SmaQ's two forms: one block up to SMALL_MAX, else the
    split form on at most BLOCKS_PER_SM blocks of THREADS per SM, with a
    partial for each in the workspace after the ticket and the constants."""
    form, blocks = S.s2fp8_plan(n, sms)
    if n <= S.SMALL_MAX:
        assert (form, blocks) == ("small", 1)
        assert S.SMALL_THREADS <= 1024
        return
    assert form == "split"
    assert blocks == min(sms * BLOCKS_PER_SM, math.ceil(n / (4 * THREADS)))
    assert S._COUNTER_WORDS + S._CONST_WORDS + 2 * blocks <= S.workspace_words(sms)
    assert S.workspace_words(sms) == 2 + 68 + 2 * 4 * sms


@pytest.mark.parametrize(
    "c_name, value",
    [("kThreads", THREADS), ("kMinBlocks", BLOCKS_PER_SM),
     ("kSmallThreads", S.SMALL_THREADS), ("kCounterWords", S._COUNTER_WORDS),
     ("kConstWords", S._CONST_WORDS), ("kTableSize", S.TABLE_SIZE),
     ("kTableBase", S.TABLE_BASE)],
)
def test_launch_constants_match_s2fp8_cu(c_name, value):
    src = _read(f"{build.CSRC}/s2fp8.cu")
    m = re.search(rf"\b{c_name} = (\d+)", src)
    assert m is not None and int(m.group(1)) == value


def test_s2fp8_e5m2_constants_match_fp8_format():
    """s2fp8.cu rounds onto e5m2 with compile-time constants; they are the
    arguments the float kernel takes for FP8_FORMAT."""
    src = _read(f"{build.CSRC}/s2fp8.cu")

    def const(name):
        m = re.search(rf"\b{name} = (-?(?:0x[0-9A-Fa-f]+|[0-9.]+))[uf]?;", src)
        assert m is not None, name
        return float(int(m.group(1), 0)) if "x" in m.group(1) else float(m.group(1))

    man, emin, max_bits, quantum_bits, c1, c2 = format_args(FP8_FORMAT)
    assert (const("kMan"), const("kEmin")) == (man, emin)
    assert (const("kMaxBits"), const("kQuantumBits")) == (max_bits, quantum_bits)
    assert (const("kQuantumScale"), 1.0) == (c1, c2)
    assert "FloatFmt e5m2{kMan, kEmin, kMaxBits, kQuantumBits, kQuantumScale, 1.f};" in src


def test_s2fp8_consts_layout_matches_read_consts():
    """``read_consts`` names the floats of csrc/s2fp8.cu's Consts in order:
    five scalars, three unused, then the table."""
    src = _read(f"{build.CSRC}/s2fp8.cu")
    assert "float mu, m, alpha, beta, inv_alpha, unused[3];" in src
    assert "float table[kTableSize];" in src
    assert S._CONST_FLOATS == 8 + S.TABLE_SIZE


# the H100's slots a thread: (233 472 B of shared memory a SM / 4 blocks
# - 1 KB reserved a block - 1 072 B static) // (256 threads x 8 B)
H100_SLOTS = 27


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM and PCIe
@pytest.mark.parametrize(
    "n", [10, K.SMALL_MAX, K.SMALL_MAX + 1, 300_001, 8_388_608, 12_582_912, 14_598_144,
          14_598_145, 50_331_648])
def test_smaq_plan_onepass_form(n, sms):
    """A bfloat16 call's three forms: the small form up to SMALL_MAX, the
    one-launch form up to the capacity (every thread of BLOCKS_PER_SM
    blocks of THREADS a SM holding ``slots`` groups of four), on the split
    form's grid, and the two launches above it; with no slots (float32)
    there is no one-launch form."""
    cap = K.onepass_capacity(sms, H100_SLOTS)
    assert cap == sms * BLOCKS_PER_SM * THREADS * 4 * H100_SLOTS
    form, blocks = K.smaq_plan(n, sms, H100_SLOTS)
    assert K.smaq_plan(n, sms) == K.smaq_plan(n, sms, 0)
    if n <= K.SMALL_MAX:
        assert (form, blocks) == ("small", 1)
        return
    assert blocks == split_blocks(n, sms)
    assert form == ("onepass" if n <= cap else "split")
    assert K.smaq_plan(n, sms)[0] == "split"
    if form == "onepass":
        # the slots the kernel takes for n on that grid fit what the card holds
        slots = -(-n // (4 * blocks * THREADS))
        assert slots <= H100_SLOTS


def test_onepass_capacity_covers_the_main_paths_maps():
    """On an H100 (132 SMs, or 114) every ResNet-18 batch-128 map and
    bert-base's 32 x 512 x 768 maps take one launch; bert-base's FFN map
    does not."""
    for sms in (132, 114):
        cap = K.onepass_capacity(sms, H100_SLOTS)
        assert 128 * 64 * 32 * 32 <= cap
        assert 32 * 512 * 768 <= cap
        assert 32 * 512 * 3072 > cap
    assert K.onepass_capacity(132, H100_SLOTS) == 14_598_144


def test_onepass_barrier_word_is_a_counter():
    """The grid barrier counts in a workspace word of its own, before the
    stats partials, and the one-launch form holds one group of four bf16 a
    slot."""
    src = _read(f"{build.CSRC}/smaq.cu")
    m = re.search(r"kStatsTicket = 0, kQuantCount = 1, kArrive = (\d+), kCounterWords = (\d+);", src)
    assert m is not None
    arrive, words = map(int, m.groups())
    assert 1 < arrive < words == K._COUNTER_WORDS
    assert K.SLOT_BYTES == 4 * torch.finfo(torch.bfloat16).bits // 8


@pytest.mark.parametrize("sms, resident", [(132, 5), (132, 8), (114, 5)])
@pytest.mark.parametrize("n", [1, 10, 2048, 2049, 300_001, 8_388_608, 50_331_648])
def test_float_bf16_launch_shape(n, sms, resident):
    """The bfloat16 float_quantize form reads 8 bf16 (16 bytes) a load, on
    every block the card holds at once and no more than one load a thread
    needs; the float32 form keeps quant_blocks' grid."""
    assert BF16_LOAD_ELEMS * torch.finfo(torch.bfloat16).bits // 8 == 16
    blocks = launch_blocks(n, torch.bfloat16, sms, resident)
    assert blocks == max(1, min(sms * resident, math.ceil(n / (BF16_LOAD_ELEMS * THREADS))))
    assert launch_blocks(n, torch.float32) == quant_blocks(n)
    src = _read(f"{build.CSRC}/float_quantize.cu")
    assert "const int64_t pairs = wide ? n >> 3 : 0;" in src


# The bfloat16 forms of S2FP8's split path and of the BN kernel
# (csrc/s2fp8.cu, csrc/smaq.cu): their launch shapes, the constants both
# sides state, and the plain version of the stats' log2 table.


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM and PCIe
@pytest.mark.parametrize(
    "n", [S.SMALL_MAX + 1, 8192, 300_001, S.BF16_WINDOW_MIN - 1, S.BF16_WINDOW_MIN, 1_048_576,
          8_388_608, 12_582_912, 50_331_648])
def test_s2fp8_bf16_quantize_shape(n, sms):
    """``s2fp8_quantize_window`` runs one block of BF16_THREADS a SM at
    most, each thread a 16-byte load (8 bf16) a step; it takes the bfloat16
    split form from BF16_WINDOW_MIN on, ``s2fp8_stats_table`` from
    BF16_TABLE_MIN, and below them the float32 kernels' bf16 instances
    serve.  The stats keep the float32 kernel's grid (the order of their
    sums) at every size."""
    assert S.BF16_LOAD_ELEMS * torch.finfo(torch.bfloat16).bits // 8 == 16
    assert S.BF16_THREADS <= 1024
    assert S.window_blocks(n, sms) == max(
        1, min(sms, math.ceil(n / (S.BF16_LOAD_ELEMS * S.BF16_THREADS))))
    assert S.split_forms(n, torch.bfloat16) == (n >= S.BF16_TABLE_MIN, n >= S.BF16_WINDOW_MIN)
    assert S.split_forms(n, torch.float32) == (False, False)
    assert S.s2fp8_plan(n, sms) == ("split", split_blocks(n, sms))
    assert S.BF16_WINDOW_MIN <= S.BF16_TABLE_MIN


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM and PCIe
@pytest.mark.parametrize("n", [1, 10, 2048, 2049, 300_001, 8_388_608, 50_331_648])
def test_bn_launch_shape(n, sms):
    """The BN kernel's bfloat16 form reads 8 bf16 (16 bytes) a thread a
    step on BLOCKS_PER_SM blocks of THREADS a SM at most; the float32 form
    keeps quant_blocks' grid."""
    assert K.BN_BF16_LOAD_ELEMS * torch.finfo(torch.bfloat16).bits // 8 == 16
    assert K.bn_blocks(n, torch.bfloat16, sms) == max(
        1, min(sms * BLOCKS_PER_SM, math.ceil(n / (K.BN_BF16_LOAD_ELEMS * THREADS))))
    assert K.bn_blocks(n, torch.float32, sms) == quant_blocks(n)
    # every block holds the constants of the most channels the kernel takes
    assert BLOCKS_PER_SM * K.MAX_BN_CHANNELS * 16 <= 227 * 1024


@pytest.mark.parametrize(
    "c_name, value",
    [("kBf16Threads", S.BF16_THREADS), ("kWindowBinades", S.WINDOW_BINADES),
     ("kLog2Split", S.LOG2_SPLIT), ("kWindowAboveMean", S.WINDOW_ABOVE_MEAN)],
)
def test_bf16_constants_match_s2fp8_cu(c_name, value):
    src = _read(f"{build.CSRC}/s2fp8.cu")
    m = re.search(rf"\b{c_name} = (\d+);", src)
    assert m is not None and int(m.group(1)) == value


@pytest.mark.parametrize(
    "name, counter", [("s2fp8_stats_table", "s2fp8_stats_table_bf16"),
                      ("s2fp8_quantize_window", "s2fp8_quantize_window_bf16")])
def test_s2fp8_table_kernels_have_their_own_entry_point_and_counter(name, counter):
    """The bfloat16 table kernels are entry points of their own, without a
    dtype (bfloat16 only) and without a size threshold on the C side (the
    wrapper's ``split_forms`` picks them), and count their launches under
    their own names."""
    params = SIGNATURES[name]
    assert params[0] == "const void* x" and "int dtype" not in params
    assert counter in S.LAUNCHES
    src = _read(f"{build.CSRC}/s2fp8.cu")
    assert "TABLE_MIN" not in src and "WINDOW_MIN" not in src


def test_bf16_tables_fit_static_shared_memory():
    """The quantize's window (16 bytes an entry when stochastic, 128
    magnitudes a binade) and the stats' log2 table (an 8-byte row for each
    of 128 mantissas and 128 subnormals, once for each of 16 lanes, and the
    rows once) fit a block's 48 KB of static shared memory beside the
    unsqueeze table and the block's reductions (the window's sample: 12
    bytes a warp)."""
    window = S.WINDOW_BINADES * 128
    assert window * 16 + S.TABLE_SIZE * 4 + S.BF16_THREADS // 32 * 12 <= 48 * 1024
    assert 256 * 16 * 8 + 256 * 8 + 32 * 16 <= 48 * 1024


def test_log2_split_is_where_log2f_halves_the_mantissa():
    """The stats take log2 as exponent + log2f of the mantissa, halved from
    LOG2_SPLIT on: the first of 128 mantissas above sqrt 2."""
    assert 1 + (S.LOG2_SPLIT - 1) / 128 < math.sqrt(2) < 1 + S.LOG2_SPLIT / 128


def test_log2_table_reference_within_one_ulp_of_torch_log2():
    """The plain version of the bfloat16 stats' log2 over all 32 768 bf16
    magnitudes against torch.log2 of each: within one float32 ulp, 0 for
    zero, and inf and NaN as log2 gives them."""
    table = S.log2_table_reference()
    h = torch.arange(1 << 15, dtype=torch.int64)
    x = (h << 16).to(torch.int32).view(torch.float32)
    ref = torch.where(h == 0, torch.zeros_like(x), torch.log2(x))
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(table), nan)
    assert torch.equal(torch.isinf(table), torch.isinf(ref))
    d = (table.view(torch.int32).long() - ref.view(torch.int32).long()).abs()
    assert int(torch.where(nan | (table == ref), torch.zeros_like(d), d).max()) <= 1
    assert float(table[0]) == 0.0
