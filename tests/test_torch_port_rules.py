"""Rules of the PyTorch port, and its checks that need a GPU.

* No file of paddle_tpu_torch/, no examples/torch_*.py, and not
  chip_smoke.py imports jax or paddle_tpu (AST scan).
* Kernel launch counters stay 0 when the entry points run on CPU tensors
  (generate, a train step, a serving engine run).
* An entry point called with no device on a machine without CUDA raises
  instead of running on the CPU; kernel wrappers refuse what their kernels
  do not take.
* The kernels against their plain versions on the card (marked `cuda`;
  skipped where torch.cuda.is_available() is False). Run them on a GPU
  machine with ``python -m pytest -m cuda tests/test_torch_port_rules.py``.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_paddle_tpu(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "paddle_tpu_torch/ops/flash_attention.py" in names
    assert "paddle_tpu_torch/inference/__init__.py" in names
    assert {"paddle_tpu_torch/models/gpt.py", "paddle_tpu_torch/bench.py",
            "paddle_tpu_torch/serving/engine.py",
            "paddle_tpu_torch/serving/pool.py",
            "paddle_tpu_torch/serving/spec.py",
            "paddle_tpu_torch/optimizer/__init__.py",
            "examples/torch_train_profile.py",
            "examples/torch_decode_profile.py",
            "paddle_tpu_torch/nn/layers/moe.py",
            "paddle_tpu_torch/models/mixtral.py",
            "paddle_tpu_torch/moe_bench.py",
            "paddle_tpu_torch/quantization/__init__.py",
            "paddle_tpu_torch/ops/rms_norm.py",
            "paddle_tpu_torch/ops/smem_probe.py",
            "paddle_tpu_torch/models/unet.py",
            "paddle_tpu_torch/nn/layers/conv.py",
            "paddle_tpu_torch/unet_bench.py",
            "paddle_tpu_torch/models/ernie.py",
            "paddle_tpu_torch/scale_report.py"} <= names
    assert len(names) >= 20


def test_counters_stay_zero_on_cpu():
    from paddle_tpu_torch.inference import generate
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_decode as fd
    fa.flash_attention_fwd.launches = 0
    fd.fused_decode_cuda.launches = 0
    m = LlamaForCausalLM(LlamaConfig.tiny(), dtype=torch.bfloat16,
                         device="cpu", seed=0)
    ids = np.random.RandomState(0).randint(0, 256, (2, 5))
    out = generate(m, ids, max_new_tokens=4, temperature=0.7, top_k=10)
    assert tuple(out.shape) == (2, 9)
    assert fa.flash_attention_fwd.launches == 0
    assert fd.fused_decode_cuda.launches == 0


def test_training_counters_stay_zero_on_cpu():
    """A GPT train step on CPU tensors runs the plain attention forward and
    backward: none of K1, K3, K4 counts a launch."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops import flash_attention as fa
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkv.launches = 0
    model, opt, x, y = bench.build(GPTConfig.tiny(), 2, 8, device="cpu")
    losses = bench.run_steps(model, opt, x, y, 2)
    assert bool(torch.isfinite(losses).all())
    assert fa.flash_attention_fwd.launches == 0
    assert fa.flash_attention_bwd_dq.launches == 0
    assert fa.flash_attention_bwd_dkv.launches == 0


def test_paged_counter_stays_zero_through_a_cpu_engine_run():
    """A serving engine on CPU tensors decodes through the paged plain
    version: K5 (and K2) count no launch."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.serving import Request, ServingEngine
    fd.fused_paged_decode_cuda.launches = 0
    fd.fused_decode_cuda.launches = 0
    m = LlamaForCausalLM(LlamaConfig.tiny(), dtype=torch.bfloat16,
                         device="cpu", seed=0)
    eng = ServingEngine(m, max_slots=2, block_tokens=16, max_seq_len=64,
                        device="cpu", temperature=0.7, top_k=10)
    prompts = np.random.RandomState(0).randint(0, 256, (3, 6))
    rids = [eng.submit(Request(p, max_new_tokens=5)) for p in prompts]
    eng.drain()
    assert all(len(eng.results[r].tokens) == 5 for r in rids)
    assert eng.stats["steps"] > 0
    assert fd.fused_paged_decode_cuda.launches == 0
    assert fd.fused_decode_cuda.launches == 0


def test_paged_wrapper_refuses_what_k5_does_not_take():
    """fused_paged_decode_cuda raises on CPU tensors, a wrong dtype and a
    non-contiguous pool, before any launch (no GPU needed)."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, h, nh, nkv, hd, ffn, b = 1, 64, 2, 1, 64, 64, 2
    bf = torch.bfloat16
    p = {"ln1": torch.ones(L, h, dtype=bf),
         "wqkv": torch.zeros(L, h, (nh + 2 * nkv) * hd, dtype=bf),
         "wo": torch.zeros(L, nh * hd, h, dtype=bf),
         "ln2": torch.ones(L, h, dtype=bf),
         "wg": torch.zeros(L, h, ffn, dtype=bf),
         "wu": torch.zeros(L, h, ffn, dtype=bf),
         "wd": torch.zeros(L, ffn, h, dtype=bf)}
    x = torch.zeros(b, h, dtype=bf)
    pool = torch.zeros(L, 4, 16, 2 * nkv * hd, dtype=bf)
    tab = torch.zeros(b, 2, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    rows = torch.zeros(b, hd)
    kw = dict(num_heads=nh, num_kv_heads=nkv)
    call = lambda *a: fd.fused_paged_decode_cuda(*a, **kw)
    with pytest.raises(ValueError, match="cuda"):
        call(x, p, pool, tab, pos, rows, rows)            # CPU tensors
    with pytest.raises(TypeError, match="float32"):
        call(x.float(), p, pool, tab, pos, rows, rows)
    with pytest.raises(TypeError, match="int32"):
        call(x, p, pool, tab.long(), pos, rows, rows)
    strided = torch.zeros(L, 4, 32, 2 * nkv * hd, dtype=bf)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        call(x, p, strided, tab, pos, rows, rows)
    assert fd.fused_paged_decode_cuda.launches == 0


def test_spec_engine_counters_stay_zero_on_cpu():
    """A speculative engine on CPU tensors verifies through the plain
    version: K7 (and K5) count no launch."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
    fd.fused_paged_verify_cuda.launches = 0
    fd.fused_paged_decode_cuda.launches = 0
    m = LlamaForCausalLM(LlamaConfig.tiny(), dtype=torch.bfloat16,
                         device="cpu", seed=0)
    eng = ServingEngine(m, max_slots=2, block_tokens=16, max_seq_len=64,
                        device="cpu", speculate=SpecConfig(k=2))
    motif = np.random.RandomState(0).randint(0, 256, (3,))
    rids = [eng.submit(Request(np.tile(motif, 4), max_new_tokens=6))
            for _ in range(2)]
    eng.drain()
    assert all(len(eng.results[r].tokens) == 6 for r in rids)
    assert eng.stats["spec_ticks"] == eng.stats["steps"] > 0
    assert fd.fused_paged_verify_cuda.launches == 0
    assert fd.fused_paged_decode_cuda.launches == 0


def test_verify_wrapper_refuses_what_k7_does_not_take(monkeypatch):
    """fused_paged_verify_cuda raises on CPU tensors, a wrong dtype and a
    non-contiguous x, before any launch; 8 slots x 9 tokens (72 tail rows,
    two launches of whole slots) get as far as the device check. A tail
    longer than one launch takes (65 tokens, once refused) runs as two
    verifies in order, of 33 and 32 tail tokens at positions p and p + 33
    (the inner calls recorded), their outputs joined in tail order."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, h, nh, nkv, hd, ffn, b, k1 = 1, 64, 2, 1, 64, 64, 2, 3
    bf = torch.bfloat16
    p = {"ln1": torch.ones(L, h, dtype=bf),
         "wqkv": torch.zeros(L, h, (nh + 2 * nkv) * hd, dtype=bf),
         "wo": torch.zeros(L, nh * hd, h, dtype=bf),
         "ln2": torch.ones(L, h, dtype=bf),
         "wg": torch.zeros(L, h, ffn, dtype=bf),
         "wu": torch.zeros(L, h, ffn, dtype=bf),
         "wd": torch.zeros(L, ffn, h, dtype=bf)}
    x = torch.zeros(b, k1, h, dtype=bf)
    pool = torch.zeros(L, 4, 16, 2 * nkv * hd, dtype=bf)
    tab = torch.zeros(b, 2, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    rows = torch.zeros(b, k1, hd)
    kw = dict(num_heads=nh, num_kv_heads=nkv)
    call = lambda *a: fd.fused_paged_verify_cuda(*a, **kw)
    with pytest.raises(ValueError, match="cuda"):
        call(x, p, pool, tab, pos, rows, rows)            # CPU tensors
    with pytest.raises(TypeError, match="float32"):
        call(x.float(), p, pool, tab, pos, rows, rows)
    with pytest.raises(TypeError, match="int32"):
        call(x, p, pool, tab, pos.long(), rows, rows)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.zeros(b, h, k1, dtype=bf).transpose(1, 2), p, pool, tab,
             pos, rows, rows)
    long_tail = torch.zeros(1, 65, h, dtype=bf)
    with pytest.raises(ValueError, match="cuda"):       # its first chunk
        call(long_tail, p, pool, tab[:1], pos[:1], rows[:1], rows[:1])
    whole = fd.fused_paged_verify_cuda
    seen = []

    def chunk(xc, params, pool_, tab_, pos_, cos_, sin_, **kw_):
        seen.append((xc.shape[1], int(pos_[0]), cos_.shape[1]))
        return torch.full_like(xc, len(seen)), pool_

    monkeypatch.setattr(fd, "fused_paged_verify_cuda", chunk)
    rope65 = torch.zeros(1, 65, hd)
    out, got_pool = whole(long_tail, p, pool, tab[:1], pos[:1] + 5, rope65,
                          rope65, **kw)
    monkeypatch.undo()
    assert seen == [(33, 5, 33), (32, 38, 32)] and got_pool is pool
    assert out.shape == long_tail.shape
    assert bool((out[:, :33] == 1).all() and (out[:, 33:] == 2).all())
    wide = torch.zeros(8, 9, h, dtype=bf)
    with pytest.raises(ValueError, match="cuda"):
        call(wide, p, pool, torch.zeros(8, 2, dtype=torch.int32),
             torch.zeros(8, dtype=torch.int32), torch.zeros(8, 9, hd),
             torch.zeros(8, 9, hd))
    assert fd.fused_paged_verify_cuda.launches == 0


def _tiny_moe(**extra):
    import dataclasses
    from paddle_tpu_torch.models import MixtralConfig, MixtralForCausalLM
    cfg = dataclasses.replace(MixtralConfig.tiny(), num_experts=8,
                              num_shared_experts=2, **extra)
    return MixtralForCausalLM(cfg, dtype=torch.bfloat16, device="cpu",
                              seed=0)


def test_moe_counter_stays_zero_through_a_cpu_generate():
    """MoE generate on CPU tensors decodes through the plain MoE step on
    the fused path: K6 (and K2) count no launch."""
    from paddle_tpu_torch.inference import generate
    from paddle_tpu_torch.ops import fused_decode as fd
    fd.fused_decode_moe_cuda.launches = 0
    fd.fused_decode_cuda.launches = 0
    m = _tiny_moe()
    assert m.fused_decode_plan(m.state_dict(include_buffers=False),
                               probe=True)["arch"] == "moe"
    ids = np.random.RandomState(0).randint(0, 256, (2, 5))
    out = generate(m, ids, max_new_tokens=4, temperature=0.7, top_k=10)
    assert tuple(out.shape) == (2, 9)
    assert fd.fused_decode_moe_cuda.launches == 0
    assert fd.fused_decode_cuda.launches == 0


def test_moe_step_refuses_int8_and_what_k6_does_not_take():
    """fused_decode_step(arch="moe") raises on int8 weights (the reference
    has no such mode, ROADMAP Queue B row 7) and on kv scales beside a
    bf16 cache; the K6 wrapper raises on CPU tensors, a wrong dtype, int8
    KV without its scales (or with scales of the wrong shape) and a top_k
    above the experts, before any launch; b = 9 (two launches of rows) and
    the int8 KV mode get as far as the device check."""
    from paddle_tpu_torch.ops import fused_decode as fd
    m = _tiny_moe(hidden_size=128, num_heads=2, num_kv_heads=1)   # hd 64
    params = fd.build_fused_params_moe(m.state_dict(include_buffers=False),
                                       2)
    x = torch.zeros(2, 128, dtype=torch.bfloat16)
    kv = torch.zeros(2, 2, 16, 2 * 64, dtype=torch.bfloat16)
    rows = torch.zeros(1, 64)
    kw = dict(num_heads=2, num_kv_heads=1, arch="moe", top_k=2)
    with pytest.raises(ValueError, match="int8 KV cache needs kv_scales"):
        fd.fused_decode_step(x, params, kv, 3, rows, rows,
                             kv_scales=torch.ones(2, 1, 128), **kw)
    with pytest.raises(NotImplementedError, match="row 7"):
        fd.fused_decode_step(x, dict(params, wqkv_s=None), kv, 3, rows,
                             rows, **kw)
    call = lambda x, p, kv: fd.fused_decode_moe_cuda(
        x, p, kv, 3, rows, rows, num_heads=2, num_kv_heads=1, top_k=2)
    with pytest.raises(ValueError, match="cuda"):
        call(x, params, kv)                                # CPU tensors
    with pytest.raises(TypeError, match="float32"):
        call(x.float(), params, kv)
    with pytest.raises(ValueError, match="cuda"):
        call(torch.zeros(9, 128, dtype=torch.bfloat16), params,
             torch.zeros(2, 9, 16, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="top_k=9"):
        fd.fused_decode_moe_cuda(x, params, kv, 3, rows, rows, num_heads=2,
                                 num_kv_heads=1, top_k=9)
    kv8 = torch.zeros(2, 2, 16, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 KV cache needs kv_scales"):
        call(x, params, kv8)
    call8 = lambda sc: fd.fused_decode_moe_cuda(
        x, params, kv8, 3, rows, rows, num_heads=2, num_kv_heads=1, top_k=2,
        kv_scales=sc)
    with pytest.raises(ValueError, match="kv_scales has shape"):
        call8(torch.ones(2, 128))
    with pytest.raises(ValueError, match="cuda"):
        call8(torch.ones(2, 1, 128))
    assert fd.fused_decode_moe_cuda.launches == 0


def test_decode_wrappers_take_64_rows():
    """K2 and K5 (llama and gpt) take 64 rows a launch and any batch in
    groups of rows: at b = 64 and b = 65 their wrappers get as far as the
    device check (CPU tensors), at b = 0 they refuse; K6 takes 8 rows a
    launch (its b = 9 is checked above). Nothing launches."""
    from paddle_tpu_torch.ops import fused_decode as fd
    assert fd.GROUP_ROWS == 64
    assert fd.MOE_MAX_ROWS == 8
    L, h, nh, hd, ffn, BT, MB = 1, 128, 2, 64, 256, 16, 2
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    llama = {"ln1": z(L, h), "wqkv": z(L, h, 3 * h), "wo": z(L, h, h),
             "ln2": z(L, h), "wg": z(L, h, ffn), "wu": z(L, h, ffn),
             "wd": z(L, ffn, h)}
    gpt = dict(llama, ln1_b=z(L, h), bqkv=z(L, 3 * h), bo=z(L, h),
               ln2_b=z(L, h), bg=z(L, ffn), bd=z(L, h))
    del gpt["wu"]
    kw = dict(num_heads=nh, num_kv_heads=nh)
    fd.fused_decode_cuda.launches = 0
    fd.fused_paged_decode_cuda.launches = 0
    for arch, p in (("llama", llama), ("gpt", gpt)):
        for b, match in ((64, "cuda"), (65, "cuda"), (0, "unsupported b=0")):
            rope = torch.zeros(1, hd), torch.zeros(1, hd)
            with pytest.raises(ValueError, match=match):
                fd.fused_decode_cuda(z(b, h), p, z(L, b, 32, 2 * h), 3,
                                     *rope, arch=arch, **kw)
            rows = torch.zeros(b, hd), torch.zeros(b, hd)
            with pytest.raises(ValueError, match=match):
                fd.fused_paged_decode_cuda(
                    z(b, h), p, z(L, 1 + MB, BT, 2 * h),
                    torch.zeros(b, MB, dtype=torch.int32),
                    torch.zeros(b, dtype=torch.int32), *rows, arch=arch,
                    **kw)
    assert fd.fused_decode_cuda.launches == 0
    assert fd.fused_paged_decode_cuda.launches == 0


def test_int8_decode_wrapper_needs_16_byte_rows():
    """The engine reads an int8 (L, in, out) stack through a TMA map,
    whose row stride must be a multiple of 16 bytes: K2's wrapper refuses
    int8 stacks with an out width that is a multiple of 8 but not 16, and
    takes one that is (as far as the device check on CPU tensors)."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, b, h, nh, hd = 1, 2, 128, 2, 64
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)
    i8 = torch.int8

    def params(ffn):
        p = {"ln1": z(L, h), "wqkv": z(L, h, 3 * h, dt=i8),
             "wo": z(L, h, h, dt=i8), "ln2": z(L, h),
             "wg": z(L, h, ffn, dt=i8), "wu": z(L, h, ffn, dt=i8),
             "wd": z(L, ffn, h, dt=i8)}
        outs = {"wqkv": 3 * h, "wo": h, "wg": ffn, "wu": ffn, "wd": h}
        p.update({f"{k}_s": torch.ones(L, 1, n) for k, n in outs.items()})
        return p

    rope = torch.zeros(1, hd), torch.zeros(1, hd)
    call = lambda p: fd.fused_decode_cuda(z(b, h), p, z(L, b, 32, 2 * h), 3,
                                          *rope, num_heads=nh,
                                          num_kv_heads=nh)
    fd.fused_decode_cuda.launches = 0
    with pytest.raises(ValueError, match="multiples of 16"):
        call(params(264))
    with pytest.raises(ValueError, match="cuda"):
        call(params(256))
    assert fd.fused_decode_cuda.launches == 0


def test_serving_engine_default_device_raises_without_cuda():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(m)
    with pytest.raises(ValueError, match="lives on"):
        ServingEngine(m, device="meta")


def test_flash_fwd_refuses_tensors_that_require_grad():
    """The raw kernel's output would be cut from the autograd graph, so
    flash_attention_fwd raises on inputs that require grad (with grad mode
    on), on any device; under no_grad it runs."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="require grad"):
        fa.flash_attention_fwd(q, q, q, is_causal=True)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, q, q, is_causal=True)
    assert out.grad_fn is None and tuple(lse.shape) == (1, 2, 4)


def test_bench_twin_refuses_cpu_by_default():
    """python -m paddle_tpu_torch.bench runs on cuda unless --device cpu is
    given; without a GPU it raises instead of timing the CPU."""
    from paddle_tpu_torch import bench
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        bench.build(*bench.config(tiny=True)[:3])


def test_ernie_twin_refuses_cpu_by_default():
    """python -m paddle_tpu_torch.scale_report ernie-titan-step runs on cuda
    unless --device cpu is given; without a GPU it raises instead of
    timing the CPU; its other subcommands exit non-zero."""
    from paddle_tpu_torch import scale_report
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        scale_report.main(["ernie-titan-step", "--tiny"])
    assert scale_report.main(["65b"]) != 0


def test_k1_counters_stay_zero_through_a_cpu_ernie_step():
    """The twin's ERNIE step on CPU tensors, and the backbone under a
    padding mask, launch no kernel: K1, K3 and K4 and their mask
    instantiations keep their counts."""
    from paddle_tpu_torch import scale_report
    from paddle_tpu_torch.models import ErnieConfig, ErnieModel
    from paddle_tpu_torch.ops import flash_attention as fa
    wraps = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv)
    before = [(w.launches, w.masked) for w in wraps]
    cfg = scale_report.config(tiny=True, seq=16)
    model, opt, state = scale_report.build(cfg, "cpu")
    scale_report.train_step(model, opt, state,
                            *scale_report.batch(cfg, 2, 16, "cpu"))
    bb = ErnieModel(ErnieConfig.tiny(), device="cpu", seed=0)
    ids = torch.zeros((2, 16), dtype=torch.long)
    mask = torch.ones((2, 1, 1, 16), dtype=torch.bool)
    mask[1, ..., 9:] = False
    bb(ids, attn_mask=mask).sum().backward()
    assert [(w.launches, w.masked) for w in wraps] == before


def test_mask_kernel_entries_take_the_mask(monkeypatch):
    """On the kernels' device (meta tensors stand for CUDA ones), K1's,
    K3's and K4's C entry points get the dense mask as one pointer to
    their general argument (am::Mod): the broadcast dims' strides 0, the
    others the mask's own, the fp32 flag, and the bounds of the kernel
    (mask_bounds' fwd, dq and dkv); the lse K3 and K4 take is the
    (b, h, sq, 2) pairs. Without a
    mask the pointer is null. The entry points raise, so nothing
    launches."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    got = {}

    class Captured(Exception):
        pass

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                got[name] = args
                raise Captured
            return entry

    monkeypatch.setattr(fa, "KERNEL_DEVICE", "meta")
    monkeypatch.setattr(fa, "_kernel_lib", lambda *a: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    b, sq, sk, h, nkv, d = 2, 200, 300, 8, 2, 64
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt,
                                                     device="meta")
    q, do, k, v = meta(b, sq, h, d), meta(b, sq, h, d), meta(b, sk, nkv, d), \
        meta(b, sk, nkv, d)
    pairs, rows = meta(b, h, sq, 2, dt=torch.float32), \
        meta(b, h, sq, dt=torch.float32)
    for mask, f32, strides in (
            (meta(b, 1, 1, sk, dt=torch.bool), 0, (sk, 0, 0, 1)),
            (meta(h, sq, sk, dt=torch.float32), 1, (0, sq * sk, sk, 1))):
        calls = ((fa.flash_attention_fwd, (q, k, v), 16),
                 (fa.flash_attention_bwd_dq, (q, k, v, do, pairs, rows), 18),
                 (fa.flash_attention_bwd_dkv, (q, k, v, do, pairs, rows),
                  19))
        for fn, args, at in calls:
            with pytest.raises(Captured):
                fn(*args, attn_mask=mask)
            arg = got[fn.__name__][at].contents
            assert (arg.sb, arg.sh, arg.sq, arg.sk) == strides
            assert arg.f32 == f32
            with pytest.raises(Captured):
                fn(*args[:4], rows, rows) if fn is not fa.flash_attention_fwd \
                    else fn(*args)
            assert not got[fn.__name__][at]
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, k, v, do, rows, rows,
                                  attn_mask=meta(sq, sk, dt=torch.bool))


def test_moe_twin_refuses_cpu_by_default():
    """python -m paddle_tpu_torch.moe_bench runs on cuda unless --device
    cpu is given; without a GPU it raises instead of timing the CPU."""
    from paddle_tpu_torch import moe_bench
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        moe_bench.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        moe_bench.build(moe_bench.config(on_card=False), 1, 8)


def _moe_backward_sources():
    """The source of every autograd Function's backward in the MoE layer,
    and of the module's helpers those call."""
    import inspect
    from paddle_tpu_torch.nn.layers import moe
    fns = [cls.backward for cls in vars(moe).values()
           if isinstance(cls, type)
           and issubclass(cls, torch.autograd.Function)
           and cls is not torch.autograd.Function]
    assert len(fns) >= 3        # _PermuteRows, _GatherDispatch, _CombineGather
    names = {n for fn in fns for n in fn.__code__.co_names}
    helpers = [getattr(moe, n) for n in sorted(names)
               if inspect.isfunction(getattr(moe, n, None))]
    return [inspect.getsource(f) for f in fns + helpers]


def test_moe_dispatch_backwards_scatter_no_rows():
    """The dispatch Functions' backwards (sort, fused, dropless) move rows
    by gathers only, the reference's design (its custom VJPs): no
    index_put_, scatter_add_, index_add_ or subscript assignment."""
    import ast
    import textwrap
    for src in _moe_backward_sources():
        for bad in ("index_put", "scatter_add", "index_add", "scatter_"):
            assert bad not in src, (bad, src)
        tree = ast.parse(textwrap.dedent(src))
        stores = [n for n in ast.walk(tree) if isinstance(n, ast.Subscript)
                  and isinstance(n.ctx, ast.Store)]
        assert not stores, src


def test_unet_twin_refuses_cpu_by_default():
    """python -m paddle_tpu_torch.unet_bench runs on cuda unless --device
    cpu is given; without a GPU it raises instead of timing the CPU, the
    DDPM training steps (--train) too."""
    from paddle_tpu_torch import unet_bench
    from paddle_tpu_torch.models import UNetConfig, UNetModel
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        unet_bench.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        unet_bench.main(["--train"])
    with pytest.raises(RuntimeError, match="cuda"):
        unet_bench.build(UNetConfig.tiny())
    with pytest.raises(RuntimeError, match="cuda"):
        UNetModel(UNetConfig.tiny())


def test_k1_counters_stay_zero_through_a_cpu_unet_forward():
    """The UNet twin on the CPU (the tiny UNet, two denoise steps, its
    attention at head dims 8 and 16) runs the plain attention: K1 counts no
    launch at any head dim."""
    from paddle_tpu_torch import unet_bench
    from paddle_tpu_torch.ops import flash_attention as fa
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_fwd.by_d = dict.fromkeys(fa.FWD_DIMS, 0)
    rec = unet_bench.main(["--device", "cpu"])
    assert rec["eps_finite"] and rec["flops_per_step"]["attention"] > 0
    assert fa.flash_attention_fwd.launches == 0
    assert set(fa.flash_attention_fwd.by_d.values()) == {0}


def test_default_device_raises_without_cuda():
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM(LlamaConfig.tiny())
    assert resolve_device("cpu").type == "cpu"


def test_cuda_wrappers_check_inputs():
    """The kernel wrappers refuse what the kernels do not take before any
    launch (these checks run without a GPU)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q)          # not a CUDA tensor
    rows = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q, q, q, q, rows, rows)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dkv(q, q, q, q, rows, rows)


def test_gpt_wrappers_refuse_what_their_kernels_do_not_take():
    """The gpt modes of K2, K5 and K7 raise on CPU tensors, a missing bias
    stack, a wrong dtype and an unknown arch, before any launch."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, h, nh, ffn, b = 1, 64, 1, 128, 2
    bf = torch.bfloat16
    z = lambda *s: torch.zeros(*s, dtype=bf)
    p = {"ln1": z(L, h), "ln1_b": z(L, h), "wqkv": z(L, h, 3 * h),
         "bqkv": z(L, 3 * h), "wo": z(L, h, h), "bo": z(L, h),
         "ln2": z(L, h), "ln2_b": z(L, h), "wg": z(L, h, ffn),
         "bg": z(L, ffn), "wd": z(L, ffn, h), "bd": z(L, h)}
    kw = dict(num_heads=nh, num_kv_heads=nh, arch="gpt")
    kv = z(L, b, 16, 2 * h)
    pool = z(L, 4, 16, 2 * h)
    tab = torch.zeros(b, 2, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    for c in (fd.fused_decode_cuda, fd.fused_paged_decode_cuda,
              fd.fused_paged_verify_cuda):
        c.launches = 0
    with pytest.raises(ValueError, match="cuda"):
        fd.fused_decode_cuda(z(b, h), p, kv, 3, None, None, **kw)
    with pytest.raises(ValueError, match="cuda"):
        fd.fused_paged_decode_cuda(z(b, h), p, pool, tab, pos, None, None,
                                   **kw)
    with pytest.raises(ValueError, match="cuda"):
        fd.fused_paged_verify_cuda(z(b, 3, h), p, pool, tab, pos, None,
                                   None, **kw)
    with pytest.raises(TypeError, match="bqkv"):
        fd.fused_decode_cuda(z(b, h), dict(p, bqkv=p["bqkv"].float()), kv, 3,
                             None, None, **kw)
    with pytest.raises(KeyError):
        fd.fused_decode_cuda(z(b, h), {k: v for k, v in p.items()
                                       if k != "bd"}, kv, 3, None, None, **kw)
    with pytest.raises(ValueError, match="arch"):
        fd.fused_decode_cuda(z(b, h), p, kv, 3, None, None, num_heads=nh,
                             num_kv_heads=nh, arch="moe")
    assert fd.fused_decode_cuda.launches == 0
    assert fd.fused_paged_decode_cuda.launches == 0
    assert fd.fused_paged_verify_cuda.launches == 0


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,d,q_off,kv_len", [
    (8, 8, 200, 260, 128, 60, 250), (8, 2, 1, 300, 64, 299, 300),
    (4, 4, 130, 130, 128, None, 130),
    # the edges of the 128-row query tile and the 128-key TMA ring
    (16, 4, 65, 333, 64, 200, 333), (8, 2, 127, 127, 128, None, 127),
    (16, 2, 129, 200, 64, 71, 150), (8, 1, 1, 300, 128, 299, 300)])
def test_flash_kernel_matches_plain(cuda, h, nkv, sq, sk, d, q_off, kv_len):
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v = mk(2, sq, h, d), mk(2, sk, nkv, d), mk(2, sk, nkv, d)
    kl = torch.tensor([kv_len, 0], dtype=torch.int32, device=cuda)
    out, lse = fa.flash_attention_fwd(q, k, v, is_causal=True,
                                      causal_offset=q_off, kv_lens=kl)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, is_causal=True,
                                                causal_offset=q_off,
                                                kv_lens=kl)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=2e-3, rtol=0)
    assert bool((out[1] == 0).all())              # kv_len 0: fully masked


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["key_padding", "fp32_4d", "bool_3d_gqa",
                                  "dead_row"])
def test_flash_kernels_mask_match_plain(cuda, form):
    """K1, K3 and K4's mask modes against their plain versions: out within
    3e-2, the pairs' lse within 2e-3 (plus 2^-22·|m|), each gradient within
    2^-6 · max|plain|, and two launches of each with the same bits."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(1)
    b, h, nkv, sq, sk, d = 2, 8, 8, 300, 333, 64
    causal = False
    if form == "key_padding":
        mask = torch.arange(sk, device=cuda)[None, None, None] < torch.tensor(
            [sk, 100], device=cuda)[:, None, None, None]
    elif form == "fp32_4d":
        mask = torch.where(torch.rand(b, h, sq, sk, generator=g,
                                      device=cuda) < 0.2, -1e4, 0.0)
        mask[:, :, 7::31] = -1e10
        mask[:, :, :128, 128:256] = float("-inf")
    elif form == "bool_3d_gqa":
        nkv, causal, d = 2, True, 128
        mask = torch.rand(h, sq, sk, generator=g, device=cuda) < 0.7
        mask[..., 0] = True
    else:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=cuda)
        mask[150] = False
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(b, sq, h, d), mk(b, sk, nkv, d), mk(b, sk, nkv, d), \
        mk(b, sq, h, d)
    kw = dict(is_causal=causal, attn_mask=mask)
    out, st = fa.flash_attention_fwd(q, k, v, **kw)
    out2, st2 = fa.flash_attention_fwd(q, k, v, **kw)
    ref, ref_st = fa.flash_attention_fwd_plain(q, k, v, **kw)
    assert torch.equal(out, out2) and torch.equal(st, st2)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    lerr = (st.double().sum(-1) - ref_st.double().sum(-1)).abs() \
        - 2.0 ** -22 * ref_st[..., 0].double().abs()
    assert lerr.max().item() <= 2e-3
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, st, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, st, delta, **kw)
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, st, delta,
                                                     **kw))
    ref_g = fa.flash_attention_bwd_plain(q, k, v, out, st, do, **kw)
    for got_g, r in zip((dq, dk, dv), ref_g):
        assert (got_g.float() - r).abs().max().item() <= \
            2.0 ** -6 * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,d,q_off,kv_len,window", [
    (16, 4, 384, 1200, 128, 700, 1100, 1),
    (16, 4, 384, 1200, 128, 700, 1100, 200),
    (8, 2, 200, 260, 64, None, 250, 129),
    (32, 8, 1, 8256, 128, 8254, 8255, 4096)])
def test_flash_kernel_window_matches_plain(cuda, h, nkv, sq, sk, d, q_off,
                                          kv_len, window):
    """K1's causal sliding window against its plain version (batch row 1
    holds no key: 0 and lse NEG_INF), two launches with the same bits."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(1)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v = mk(2, sq, h, d), mk(2, sk, nkv, d), mk(2, sk, nkv, d)
    kl = torch.tensor([kv_len, 0], dtype=torch.int32, device=cuda)
    kw = dict(is_causal=True, causal_offset=q_off, kv_lens=kl, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=2e-3, rtol=0)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert bool((out[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,d,causal,q_off,kv_len", [
    (8, 8, 256, 77, 256, False, None, None),
    (8, 8, 129, 333, 256, False, None, None),
    (8, 2, 200, 260, 256, True, 60, 250),
    (8, 8, 1, 300, 256, True, 299, 300)])
def test_flash_kernel_head_dim_256_matches_plain(cuda, h, nkv, sq, sk, d,
                                                 causal, q_off, kv_len):
    """K1 at d 256 (64-key tiles): ragged non-causal sk without kv_lens,
    causal with an offset, GQA, sq 1; batch row 1 of a kv_lens case holds
    no key (0 and lse NEG_INF)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(2)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v = mk(2, sq, h, d), mk(2, sk, nkv, d), mk(2, sk, nkv, d)
    kl = (None if kv_len is None else
          torch.tensor([kv_len, 0], dtype=torch.int32, device=cuda))
    kw = dict(is_causal=causal, causal_offset=q_off, kv_lens=kl)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=2e-3, rtol=0)
    if kl is not None:
        assert bool((out[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,causal,q_off,kv_len", [
    (8, 8, 256, 77, False, None, None),
    (8, 2, 65, 333, True, 200, 333),
    (8, 8, 1, 300, True, 299, 300)])
def test_flash_bwd_kernels_head_dim_256_match_plain(cuda, h, nkv, sq, sk,
                                                    causal, q_off, kv_len):
    """K3/K4 at d 256 (32-key K3 tiles; 64-key K4 blocks whose consumer
    groups split the columns) on K1's (out, lse) against the plain
    backward: each gradient within 2^-6 · max|plain|, batch row 1 of a
    kv_lens case (no key) zero, two launches bitwise equal."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(6)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(2, sq, h, 256), mk(2, sk, nkv, 256), \
        mk(2, sk, nkv, 256), mk(2, sq, h, 256)
    kl = (None if kv_len is None else
          torch.tensor([kv_len, 0], dtype=torch.int32, device=cuda))
    kw = dict(is_causal=causal, causal_offset=q_off, kv_lens=kl)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    refs = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    for got, r in zip((dq, dk, dv), refs):
        assert (got.float() - r).abs().max().item() <= \
            2 ** -6 * r.abs().max().item()
        if kl is not None:
            assert not got[1].any()
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                     **kw))
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_attention_dispatch_pads_sd_head_dims_on_the_card(cuda, d):
    """SD-1.5's head dims through the dispatch (K1 at the padded d) against
    the plain version at the unpadded d: self-attention and 77-token
    cross-attention."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(3)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    for sq, sk in ((256, 256), (256, 77)):
        q, k, v = mk(2, sq, 8, d), mk(2, sk, 8, d), mk(2, sk, 8, d)
        with torch.no_grad():
            out = fa.scaled_dot_product_attention(q, k, v)
        ref, _ = fa.flash_attention_fwd_plain(q, k, v)
        torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nkv", [4, 1])
def test_fused_decode_kernel_matches_plain(cuda, nkv):
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, S, nh, hd, h, ffn, pos = 2, 3, 256, 4, 128, 512, 1024, 150
    g = torch.Generator(device=cuda).manual_seed(1)
    mk = lambda *s, sc=0.05: (torch.randn(*s, generator=g, device=cuda)
                              * sc).bfloat16()
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + mk(L, h, sc=0.1), "wqkv": mk(L, h, dq + 2 * dkv),
         "wo": mk(L, dq, h), "ln2": 1 + mk(L, h, sc=0.1),
         "wg": mk(L, h, ffn), "wu": mk(L, h, ffn), "wd": mk(L, ffn, h)}
    x = mk(b, h, sc=1.0)
    kv = mk(L, b, S, 2 * dkv, sc=1.0)
    kv[:, :, pos:] = 0
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xk, kvk = fd.fused_decode_cuda(x, p, kv.clone(), pos, cos[pos:pos + 1],
                                   sin[pos:pos + 1], **kw)
    xr, kvr = fd.fused_decode_reference(x, p, kv.clone(), pos,
                                        cos[pos:pos + 1], sin[pos:pos + 1],
                                        **kw)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(kvk.float(), kvr.float(), atol=5e-2,
                               rtol=2 ** -7)
    assert math.isfinite(float(xk.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,d,causal,lens", [
    (4, 4, 200, 200, 64, True, [200, 0]),
    (8, 2, 130, 300, 128, True, [300, 257]),
    (4, 4, 70, 90, 64, False, None),
    (4, 2, 300, 200, 64, True, None),          # sq > sk: empty top rows
    # K4's tile edges: 64-query tiles past 128-key blocks, GQA 4 and 8
    (16, 4, 65, 333, 128, True, [333, 0]),
    (16, 2, 127, 200, 64, True, [150, 200]),
    (8, 1, 129, 129, 128, True, None),
    (8, 2, 1, 300, 64, True, None)])
def test_flash_bwd_kernels_match_plain(cuda, h, nkv, sq, sk, d, causal,
                                       lens):
    """K3/K4 through FlashAttention against flash_attention_bwd_plain on the
    kernel forward's (out, lse), bf16 inputs: each gradient within
    2^-6 · max|plain| (bf16 P and dS in the products, bf16 outputs); a
    kv_len of 0 gives zero gradients."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(2)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(2, sq, h, d), mk(2, sk, nkv, d), mk(2, sk, nkv, d), \
        mk(2, sq, h, d)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, is_causal=causal,
                                          kv_lens=kl)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                       is_causal=causal, kv_lens=kl)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.scaled_dot_product_attention(*leaves, is_causal=causal,
                                        kv_lens=kl)
    o.backward(do)
    for t, r in zip(leaves, ref):
        err = (t.grad.float() - r).abs().max().item()
        assert err <= 2 ** -6 * r.abs().max().item(), err
    if lens is not None and 0 in lens:
        assert all(not t.grad[1].any() for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (4, 333, 65)), (torch.float32, (3, 1000, 7)),
    (torch.bfloat16, (5, 17))])
def test_dropout_kernel_matches_plain_bitwise(cuda, dtype, shape):
    """The hidden-dropout kernel against its plain version, bit for bit,
    p 0.1, 0.5 and 1, dividing by keep or not; a misaligned view copied
    first gives the same bits."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import dropout as dops
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    key = rng.fold_in(rng.PRNGKey(123), 4)
    for p in (0.1, 0.5, 1.0):
        for divide in (True, False):
            assert torch.equal(dops.dropout_cuda(x, key, p, divide),
                               dops.dropout_plain(x, key, p, divide))
    flat = x.reshape(-1)[1:]
    assert torch.equal(dops.dropout_cuda(flat, key, 0.1),
                       dops.dropout_plain(flat, key, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,d,causal,q_off,lens,window", [
    (4, 4, 256, 256, 64, True, None, None, None),
    (16, 4, 300, 333, 128, True, 33, [333, 100], None),
    (8, 2, 200, 500, 64, False, None, [450, 0], None),
    (8, 2, 384, 1084, 128, True, 700, None, 200)])
def test_flash_kernels_dropout_match_plain(cuda, h, nkv, sq, sk, d, causal,
                                           q_off, lens, window):
    """K1, K3 and K4's dropout modes against the plain versions with the
    same key: out within K1's 3e-2, lse bit for bit the dropout-free
    kernel's, each gradient within 2^-6 · max|plain|, two launches bitwise
    equal."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(9)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(2, sq, h, d), mk(2, sk, nkv, d), mk(2, sk, nkv, d), \
        mk(2, sq, h, d)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda)
    base = dict(is_causal=causal, causal_offset=q_off, kv_lens=kl,
                window=window)
    kw = dict(base, dropout_p=0.1, key=rng.fold_in(rng.PRNGKey(3), 1))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
    _, lse0 = fa.flash_attention_fwd(q, k, v, **base)
    ref, _ = fa.flash_attention_fwd_plain(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2
    assert torch.equal(lse, lse0) and torch.equal(out, out2)
    refs = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    for got, r in zip((dq, dk, dv), refs):
        assert (got.float() - r).abs().max().item() <= \
            2 ** -6 * r.abs().max().item()
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                     **kw))
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("h,nkv,sq,sk,d,q_off,lens,window", [
    (16, 4, 384, 1200, 128, 700, [1100, 0], 1),
    (16, 4, 384, 1200, 128, 700, [1100, 900], 64),
    (16, 2, 300, 700, 64, 333, [700, 500], 200),
    (8, 8, 256, 256, 64, None, None, 129),
    (32, 8, 512, 512, 128, None, [512, 300], 100)])
def test_flash_bwd_kernels_window_match_plain(cuda, h, nkv, sq, sk, d, q_off,
                                              lens, window):
    """K3/K4's causal sliding window through FlashAttention against
    flash_attention_bwd_plain with the window, on the windowed forward's
    (out, lse): each gradient within 2^-6 · max|plain| (K3/K4's tolerance;
    at window 1, where dq and dk are 0 in exact arithmetic, within the fp32
    noise of the cancelling sums); a kv_len of 0 gives zero gradients; K3 and K4 each launched twice on the
    same inputs give the same bits; a window at or above every row's span
    gives the windowless launches' bits."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(5)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(2, sq, h, d), mk(2, sk, nkv, d), mk(2, sk, nkv, d), \
        mk(2, sq, h, d)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda)
    kw = dict(is_causal=True, causal_offset=q_off, kv_lens=kl)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, window=window, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, window=window,
                                       **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.scaled_dot_product_attention(*leaves, window_size=window, **kw)
    o.backward(do)
    # window 1: P = 1 and dS = dP − Δ = 0 exactly, so dq and dk are the
    # fp32 noise of dP and Δ's sums on both sides (chip_smoke.cancel_noise)
    cancel = 0.0
    if window == 1:
        terms = (do.float() * out.float()).abs().sum(-1).max().item()
        cancel = ((h // nkv) * d * 2.0 ** -22 * terms / math.sqrt(d)
                  * max(q.float().abs().max().item(),
                        k.float().abs().max().item()))
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        err = (t.grad.float() - r).abs().max().item()
        tol = 2 ** -6 * r.abs().max().item()
        assert err <= (tol if name == "dv" else max(tol, cancel)), err
    if lens is not None and 0 in lens:
        assert all(not t.grad[1].any() for t in leaves)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        first = fn(q, k, v, do, lse, delta, window=window, **kw)
        second = fn(q, k, v, do, lse, delta, window=window, **kw)
        wide = fn(q, k, v, do, lse, delta, window=1 << 20, **kw)
        plain = fn(q, k, v, do, lse, delta, **kw)
        for a, b_, c, e in zip(*(t if isinstance(t, tuple) else (t,)
                                 for t in (first, second, wide, plain))):
            assert torch.equal(a, b_)
            assert torch.equal(c, e)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("h,nkv,d", [(16, 2, 64), (16, 4, 128)])
def test_flash_dkv_kernel_two_launches_bitwise(cuda, h, nkv, d, kernel):
    """K4 sums the GQA heads of a kv head, and K3 the key tiles of a query
    row, in fp32 in a fixed order, with no atomics: two launches on the
    same inputs give the same bits."""
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(3)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v, do = mk(2, 300, h, d), mk(2, 300, nkv, d), mk(2, 300, nkv, d), \
        mk(2, 300, h, d)
    out, lse = fa.flash_attention_fwd(q, k, v, is_causal=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    fn = getattr(fa, f"flash_attention_bwd_{kernel}")
    first = fn(q, k, v, do, lse, delta, is_causal=True)
    second = fn(q, k, v, do, lse, delta, is_causal=True)
    if kernel == "dq":
        first, second = (first,), (second,)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("nkv", [4, 1])
def test_paged_decode_kernel_matches_plain_and_k2(cuda, nkv):
    """K5 against its plain version over a shuffled block table with an
    idle row, and bitwise against K2 when every row sits at one position
    over the same KV."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, nh, hd, h, ffn, BT, MB = 2, 3, 4, 128, 512, 1024, 16, 8
    g = torch.Generator(device=cuda).manual_seed(3)
    mk = lambda *s, sc=0.05: (torch.randn(*s, generator=g, device=cuda)
                              * sc).bfloat16()
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + mk(L, h, sc=0.1), "wqkv": mk(L, h, dq + 2 * dkv),
         "wo": mk(L, dq, h), "ln2": 1 + mk(L, h, sc=0.1),
         "wg": mk(L, h, ffn), "wu": mk(L, h, ffn), "wd": mk(L, ffn, h)}
    x = mk(b, h, sc=1.0)
    pool = mk(L, 1 + b * MB, BT, 2 * dkv, sc=1.0)
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(0))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32).to(cuda)
    tab[2] = 0                                        # an idle row
    cos, sin = rope_cos_sin(BT * MB, hd, device=cuda)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    pos = torch.tensor([77, 120, 5], dtype=torch.int32, device=cuda)
    c, s = cos.index_select(0, pos), sin.index_select(0, pos)
    xk, pk = fd.fused_paged_decode_cuda(x, p, pool.clone(), tab, pos, c, s,
                                        **kw)
    xr, pr = fd.fused_paged_decode_reference(x, p, pool.clone(), tab, pos,
                                             c, s, **kw)
    torch.testing.assert_close(xk[:2].float(), xr[:2].float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(pk[:, 1:].float(), pr[:, 1:].float(),
                               atol=5e-2, rtol=2 ** -7)
    tab[2] = (perm[2 * MB:] + 1).to(torch.int32).to(cuda)
    at = 100
    cache = torch.stack([pool[:, tab[r].long()].reshape(L, MB * BT, -1)
                         for r in range(b)], dim=1)
    x2, cache = fd.fused_decode_cuda(x, p, cache, at, cos[at:at + 1],
                                     sin[at:at + 1], **kw)
    p5 = torch.full((b,), at, dtype=torch.int32, device=cuda)
    x5, pool = fd.fused_paged_decode_cuda(
        x, p, pool, tab, p5, cos.index_select(0, p5),
        sin.index_select(0, p5), **kw)
    assert torch.equal(x5, x2)


@pytest.mark.cuda
@pytest.mark.parametrize("nkv", [4, 1])
def test_paged_verify_kernel_matches_plain(cuda, nkv):
    """K7 against its plain version over a shuffled block table: one tail
    crossing a block boundary, one running past the table (scratch), one
    idle row. x_out of mapped tail tokens, the appended rows, and every
    other row of every block but scratch."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, K1, nh, hd, h, ffn, BT, MB = 2, 4, 5, 4, 128, 512, 1024, 16, 8
    g = torch.Generator(device=cuda).manual_seed(4)
    mk = lambda *s, sc=0.05: (torch.randn(*s, generator=g, device=cuda)
                              * sc).bfloat16()
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + mk(L, h, sc=0.1), "wqkv": mk(L, h, dq + 2 * dkv),
         "wo": mk(L, dq, h), "ln2": 1 + mk(L, h, sc=0.1),
         "wg": mk(L, h, ffn), "wu": mk(L, h, ffn), "wd": mk(L, ffn, h)}
    x = mk(b, K1, h, sc=1.0)
    pool = mk(L, 1 + b * MB, BT, 2 * dkv, sc=1.0)
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(1))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32)
    tab[1, 3:] = 0                  # row 1 maps 3 blocks: 46..50 crosses
    tab[3] = 0                      # an idle row
    tab = tab.to(cuda)
    positions = [30, 46, MB * BT - 2, 3]   # row 0 crosses 31 | 32
    mapped = [(0, j) for j in range(K1)] + [(1, 0), (1, 1)] + \
        [(2, 0), (2, 1)]
    S = BT * MB
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    pj = torch.clamp(torch.tensor(positions, device=cuda)[:, None]
                     + torch.arange(K1, device=cuda)[None], max=S - 1)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xk, pk = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos,
                                        cos[pj], sin[pj], **kw)
    xr, pr = fd.fused_paged_verify_reference(x, p, pool.clone(), tab, pos,
                                             cos[pj], sin[pj], **kw)
    rr = torch.tensor([r for r, _ in mapped], device=cuda)
    jj = torch.tensor([j for _, j in mapped], device=cuda)
    torch.testing.assert_close(xk[rr, jj].float(), xr[rr, jj].float(),
                               atol=5e-2, rtol=2 ** -7)
    t = pos.long()[rr] + jj
    bids, offs = tab.long()[rr, t // BT], t % BT
    torch.testing.assert_close(pk[:, bids, offs].float(),
                               pr[:, bids, offs].float(), atol=5e-2,
                               rtol=2 ** -7)
    rest = torch.ones(pool.shape[1:3], dtype=torch.bool, device=cuda)
    rest[bids, offs] = False
    rest[0] = False
    assert torch.equal(pk[:, rest], pr[:, rest])
    assert torch.equal(pk[:, rest], pool[:, rest])


@pytest.mark.cuda
@pytest.mark.parametrize("nkv,k,fs", [(4, 2, 0), (2, 4, 256)])
def test_moe_decode_kernel_matches_plain(cuda, nkv, k, fs):
    """K6 against its plain version with the gate ×8 (decisive routing):
    the same expert sets at every layer, x_out and the appended rows at
    K2's tolerance, the rest of the cache untouched, two launches bitwise
    equal."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, S, nh, hd, h, E, f, pos = 2, 4, 256, 4, 128, 512, 16, 256, 150
    g = torch.Generator(device=cuda).manual_seed(5)
    mk = lambda *s, sc=0.05: (torch.randn(*s, generator=g, device=cuda)
                              * sc).bfloat16()
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + mk(L, h, sc=0.1), "wqkv": mk(L, h, dq + 2 * dkv),
         "wo": mk(L, dq, h), "ln2": 1 + mk(L, h, sc=0.1),
         "gate": mk(L, E, h, sc=0.4), "weg": mk(L, E, h, f),
         "weu": mk(L, E, h, f), "wed": mk(L, E, f, h)}
    if fs:
        p.update(wsg=mk(L, h, fs), wsu=mk(L, h, fs), wsd=mk(L, fs, h))
    x = mk(b, h, sc=1.0)
    kv = mk(L, b, S, 2 * dkv, sc=1.0)
    kv[:, :, pos:] = 0
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, top_k=k)
    kr, kr2, pr = {}, {}, {}
    xk, kvk = fd.fused_decode_moe_cuda(x, p, kv.clone(), pos, c, s,
                                       routing=kr, **kw)
    xk2, kvk2 = fd.fused_decode_moe_cuda(x, p, kv.clone(), pos, c, s,
                                         routing=kr2, **kw)
    xr, kvr = fd.fused_decode_reference(x, p, kv.clone(), pos, c, s,
                                        arch="moe", routing=pr, **kw)
    assert torch.equal(xk, xk2) and torch.equal(kvk, kvk2)
    assert torch.equal(kr["ids"].long().sort(-1).values,
                       pr["ids"].sort(-1).values)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(kvk.float(), kvr.float(), atol=5e-2,
                               rtol=2 ** -7)
    assert torch.equal(kvk[:, :, :pos], kv[:, :, :pos])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 9])
def test_moe_decode_kernel_int8_kv_matches_plain(cuda, b):
    """K6's int8 KV mode against the int8 plain version on the same int8
    cache, gate ×8: the same expert sets, x_out at K2's tolerance, the
    appended int8 rows within one int8 step, the rest of the cache
    untouched, two launches bitwise equal (b = 9: two launches of rows)."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, S, nh, nkv, hd, h, E, f, k, pos = 2, 256, 4, 2, 128, 512, 16, 256, 4, 150
    g = torch.Generator(device=cuda).manual_seed(7)
    mk = lambda *s, sc=0.05: (torch.randn(*s, generator=g, device=cuda)
                              * sc).bfloat16()
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + mk(L, h, sc=0.1), "wqkv": mk(L, h, dq + 2 * dkv),
         "wo": mk(L, dq, h), "ln2": 1 + mk(L, h, sc=0.1),
         "gate": mk(L, E, h, sc=0.4), "weg": mk(L, E, h, f),
         "weu": mk(L, E, h, f), "wed": mk(L, E, f, h)}
    x = mk(b, h, sc=1.0)
    kv8, sc = fd.quantize_kv_cache(mk(L, b, S, 2 * dkv, sc=1.0), nkv)
    kv8[:, :, pos:] = 0
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, top_k=k,
              kv_scales=sc)
    kr, pr = {}, {}
    n0 = fd.fused_decode_moe_cuda.int8_kv
    xk, kvk = fd.fused_decode_moe_cuda(x, p, kv8.clone(), pos, c, s,
                                       routing=kr, **kw)
    xk2, kvk2 = fd.fused_decode_moe_cuda(x, p, kv8.clone(), pos, c, s, **kw)
    assert fd.fused_decode_moe_cuda.int8_kv - n0 == 2 * (1 + (b > 8))
    xr, kvr = fd.fused_decode_reference(x, p, kv8.clone(), pos, c, s,
                                        arch="moe", routing=pr, **kw)
    assert torch.equal(xk, xk2) and torch.equal(kvk, kvk2)
    assert torch.equal(kr["ids"].long().sort(-1).values,
                       pr["ids"].sort(-1).values)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    assert int((kvk[:, :, pos].int() - kvr[:, :, pos].int()).abs().max()) <= 1
    assert torch.equal(kvk[:, :, :pos], kv8[:, :, :pos])
    assert torch.equal(kvk[:, :, pos + 1:], kv8[:, :, pos + 1:])


def _gpt_cuda_params(g, L, h, ffn):
    """Random bf16 gpt stacks on the card (build_fused_params_gpt's keys)."""
    mk = lambda *s, sc=0.05: (torch.randn(*s, generator=g, device="cuda")
                              * sc).bfloat16()
    return {"ln1": 1 + mk(L, h, sc=0.1), "ln1_b": mk(L, h, sc=0.1),
            "wqkv": mk(L, h, 3 * h), "bqkv": mk(L, 3 * h, sc=0.1),
            "wo": mk(L, h, h), "bo": mk(L, h, sc=0.1),
            "ln2": 1 + mk(L, h, sc=0.1), "ln2_b": mk(L, h, sc=0.1),
            "wg": mk(L, h, ffn), "bg": mk(L, ffn, sc=0.1),
            "wd": mk(L, ffn, h), "bd": mk(L, h, sc=0.1)}


@pytest.mark.cuda
def test_fused_decode_gpt_kernel_matches_plain(cuda):
    """K2's gpt mode against the plain gpt step: x_out and the cache at K2's
    tolerance, the rest of the cache untouched, two launches bitwise
    equal."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, b, S, nh, hd, pos = 2, 3, 256, 4, 64, 150
    h, ffn = nh * hd, 4 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(6)
    p = _gpt_cuda_params(g, L, h, ffn)
    x = (torch.randn(b, h, generator=g, device=cuda) + 0.5).bfloat16()
    kv = torch.randn(L, b, S, 2 * h, generator=g, device=cuda).bfloat16()
    kv[:, :, pos:] = 0
    kw = dict(num_heads=nh, num_kv_heads=nh, eps=1e-5, arch="gpt")
    xk, kvk = fd.fused_decode_cuda(x, p, kv.clone(), pos, None, None, **kw)
    xk2, kvk2 = fd.fused_decode_cuda(x, p, kv.clone(), pos, None, None, **kw)
    xr, kvr = fd.fused_decode_reference(x, p, kv.clone(), pos, None, None,
                                        **kw)
    assert torch.equal(xk, xk2) and torch.equal(kvk, kvk2)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(kvk.float(), kvr.float(), atol=5e-2,
                               rtol=2 ** -7)
    assert torch.equal(kvk[:, :, :pos], kv[:, :, :pos])


@pytest.mark.cuda
def test_paged_decode_gpt_kernel_matches_plain_and_k2(cuda):
    """K5's gpt mode against the plain paged gpt step over a shuffled table
    with an idle row, and bitwise against K2's gpt mode with every row at
    one position over the same KV."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, b, nh, hd, BT, MB = 2, 3, 4, 64, 16, 8
    h, ffn = nh * hd, 4 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(7)
    p = _gpt_cuda_params(g, L, h, ffn)
    x = torch.randn(b, h, generator=g, device=cuda).bfloat16()
    pool = torch.randn(L, 1 + b * MB, BT, 2 * h, generator=g,
                       device=cuda).bfloat16()
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(0))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32).to(cuda)
    tab[2] = 0                                        # an idle row
    kw = dict(num_heads=nh, num_kv_heads=nh, eps=1e-5, arch="gpt")
    pos = torch.tensor([77, 120, 5], dtype=torch.int32, device=cuda)
    xk, pk = fd.fused_paged_decode_cuda(x, p, pool.clone(), tab, pos, None,
                                        None, **kw)
    xr, pr = fd.fused_paged_decode_reference(x, p, pool.clone(), tab, pos,
                                             None, None, **kw)
    torch.testing.assert_close(xk[:2].float(), xr[:2].float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(pk[:, 1:].float(), pr[:, 1:].float(),
                               atol=5e-2, rtol=2 ** -7)
    tab[2] = (perm[2 * MB:] + 1).to(torch.int32).to(cuda)
    at = 100
    cache = torch.stack([pool[:, tab[r].long()].reshape(L, MB * BT, -1)
                         for r in range(b)], dim=1)
    x2, cache = fd.fused_decode_cuda(x, p, cache, at, None, None, **kw)
    p5 = torch.full((b,), at, dtype=torch.int32, device=cuda)
    x5, pool = fd.fused_paged_decode_cuda(x, p, pool, tab, p5, None, None,
                                          **kw)
    assert torch.equal(x5, x2)


@pytest.mark.cuda
def test_paged_verify_gpt_kernel_matches_plain(cuda):
    """K7's gpt mode against the plain gpt verify over a shuffled table: a
    tail crossing a block boundary, one past the table, an idle row."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, b, K1, nh, hd, BT, MB = 2, 4, 5, 4, 64, 16, 8
    h, ffn = nh * hd, 4 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(8)
    p = _gpt_cuda_params(g, L, h, ffn)
    x = torch.randn(b, K1, h, generator=g, device=cuda).bfloat16()
    pool = torch.randn(L, 1 + b * MB, BT, 2 * h, generator=g,
                       device=cuda).bfloat16()
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(1))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32)
    tab[1, 3:] = 0
    tab[3] = 0
    tab = tab.to(cuda)
    positions = [30, 46, MB * BT - 2, 3]
    mapped = [(0, j) for j in range(K1)] + [(1, 0), (1, 1)] + \
        [(2, 0), (2, 1)]
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    kw = dict(num_heads=nh, num_kv_heads=nh, eps=1e-5, arch="gpt")
    xk, pk = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos, None,
                                        None, **kw)
    xr, pr = fd.fused_paged_verify_reference(x, p, pool.clone(), tab, pos,
                                             None, None, **kw)
    rr = torch.tensor([r for r, _ in mapped], device=cuda)
    jj = torch.tensor([j for _, j in mapped], device=cuda)
    torch.testing.assert_close(xk[rr, jj].float(), xr[rr, jj].float(),
                               atol=5e-2, rtol=2 ** -7)
    t = pos.long()[rr] + jj
    bids, offs = tab.long()[rr, t // BT], t % BT
    torch.testing.assert_close(pk[:, bids, offs].float(),
                               pr[:, bids, offs].float(), atol=5e-2,
                               rtol=2 ** -7)
    rest = torch.ones(pool.shape[1:3], dtype=torch.bool, device=cuda)
    rest[bids, offs] = False
    rest[0] = False
    assert torch.equal(pk[:, rest], pool[:, rest])


@pytest.mark.cuda
def test_gpt_generate_on_the_card_runs_k1_and_k2(cuda):
    """A small GPT generates on the card: the prefill's strided q/k/v views
    reach K1 without a gradient (one launch per layer), and every decode
    step is one K2 launch in its gpt mode."""
    from paddle_tpu_torch.inference import generate
    from paddle_tpu_torch.models import GPTConfig, GPTPretrainModel
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_decode as fd
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, max_position_embeddings=256,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    m = GPTPretrainModel(cfg, dtype=torch.bfloat16, device="cuda",
                         seed=0).eval()
    ids = torch.randint(0, 512, (2, 40), generator=torch.Generator()
                        .manual_seed(0))
    fa.flash_attention_fwd.launches = 0
    fd.fused_decode_cuda.launches = 0
    out = generate(m, ids, max_new_tokens=6)
    assert fa.flash_attention_fwd.launches == cfg.num_layers
    assert fd.fused_decode_cuda.launches == 5
    assert tuple(out.shape) == (2, 46)
    assert torch.equal(out[:, :40].cpu(), ids)


def _llama_cuda_params(L, h, nh, nkv, ffn, int8):
    """A random bf16 llama's fused stacks (seed 8); int8: the model
    through quantize_model first, as the int8 generate path builds them."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = LlamaConfig(vocab_size=64, hidden_size=h, intermediate_size=ffn,
                      num_layers=L, num_heads=nh, num_kv_heads=nkv)
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda",
                             seed=8)
    if int8:
        quantize_model(model)
    state = model.state_dict(include_buffers=False)
    return model.fused_decode_plan(state)["params"]


@pytest.mark.cuda
@pytest.mark.parametrize("w8,kv8", [(True, False), (False, True),
                                    (True, True)])
def test_fused_decode_int8_modes_match_plain(cuda, w8, kv8):
    """K2's int8 modes (llama) against the plain int8 step: x_out at K2's
    tolerance, the appended int8 rows within one int8 step, the rest of the
    cache untouched, two launches bitwise equal."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, S, nh, nkv, hd, pos = 2, 3, 256, 8, 2, 64, 150
    h, ffn = nh * hd, 3 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(8)
    p = _llama_cuda_params(L, h, nh, nkv, ffn, w8)
    x = torch.randn(b, h, generator=g, device=cuda).bfloat16()
    kv = torch.randn(L, b, S, 2 * nkv * hd, generator=g,
                     device=cuda).bfloat16()
    kv[:, :, pos:] = 0
    scales = None
    if kv8:
        kv, scales = fd.quantize_kv_cache(kv, nkv)
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, kv_scales=scales)
    xk, kvk = fd.fused_decode_cuda(x, p, kv.clone(), pos, c, s, **kw)
    xk2, kvk2 = fd.fused_decode_cuda(x, p, kv.clone(), pos, c, s, **kw)
    xr, kvr = fd.fused_decode_reference(x, p, kv.clone(), pos, c, s, **kw)
    assert torch.equal(xk, xk2) and torch.equal(kvk, kvk2)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    if kv8:
        assert (kvk[:, :, pos].int() - kvr[:, :, pos].int()).abs().max() <= 1
    else:
        torch.testing.assert_close(kvk.float(), kvr.float(), atol=5e-2,
                                   rtol=2 ** -7)
    assert torch.equal(kvk[:, :, :pos], kv[:, :, :pos])


#: the split-KV attention's chunk edges (512-key chunks): one key, two, a
#: full chunk, one and two keys past it, two full chunks and one past them,
#: a third chunk part-filled
EDGE_POS = (0, 1, 511, 512, 513, 1023, 1024, 1500)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,nkv,kv8", [("llama", 4, False),
                                          ("llama", 1, False),
                                          ("llama", 4, True),
                                          ("gpt", 4, False), ("gpt", 4, True)])
def test_decode_kernel_at_chunk_edges(cuda, arch, nkv, kv8):
    """K2 (llama MHA and GQA 4, gpt; bf16 and int8 cache) at each of
    EDGE_POS over a cache of 1501 rows (the last edge on its last row):
    x_out at K2's tolerance, the appended row at K2's tolerance (int8:
    within one int8 step), the rest of the cache untouched, two launches
    bitwise equal. The int8 cache runs one layer, as chip_smoke.py's k2q
    edges do (a second layer's appends are quantized from noisy x)."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, S, nh = 1 if kv8 else 2, 2, 1501, 4
    hd = 128 if arch == "llama" else 64
    h, ffn = nh * hd, 2 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(10)
    p = (_gpt_cuda_params(g, L, h, ffn) if arch == "gpt"
         else _llama_cuda_params(L, h, nh, nkv, ffn, False))
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    for pos in EDGE_POS:
        x = torch.randn(b, h, generator=g, device=cuda).bfloat16()
        kv = torch.randn(L, b, S, 2 * nkv * hd, generator=g,
                         device=cuda).bfloat16()
        kv[:, :, pos:] = 0
        scales = None
        if kv8:   # scales from random rows at every position: at pos 0 the
            # filled prefix is empty and the floor scale 1e-8 would make
            # each append ±127 by its sign alone
            src = torch.randn(kv.shape, generator=g, device=cuda).bfloat16()
            src[:, :, :pos] = kv[:, :, :pos]
            kv, scales = fd.quantize_kv_cache(src, nkv)
            kv[:, :, pos:] = 0
        c, s = (None, None) if arch == "gpt" else (cos[pos:pos + 1],
                                                   sin[pos:pos + 1])
        kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch,
                  kv_scales=scales)
        xk, kvk = fd.fused_decode_cuda(x, p, kv.clone(), pos, c, s, **kw)
        xk2, kvk2 = fd.fused_decode_cuda(x, p, kv.clone(), pos, c, s, **kw)
        xr, kvr = fd.fused_decode_reference(x, p, kv.clone(), pos, c, s,
                                            **kw)
        assert torch.equal(xk, xk2) and torch.equal(kvk, kvk2), pos
        torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                                   rtol=2 ** -7, msg=f"pos {pos}")
        if kv8:
            assert (kvk[:, :, pos].int() - kvr[:, :, pos].int()).abs().max() \
                <= 1, pos
        else:
            torch.testing.assert_close(kvk[:, :, pos].float(),
                                       kvr[:, :, pos].float(), atol=5e-2,
                                       rtol=2 ** -7, msg=f"pos {pos}")
        assert torch.equal(kvk[:, :, :pos], kv[:, :, :pos]), pos
        assert torch.equal(kvk[:, :, pos + 1:], kv[:, :, pos + 1:]), pos


@pytest.mark.cuda
@pytest.mark.parametrize("arch,BT", [("llama", 16), ("llama", 12),
                                     ("gpt", 16), ("gpt", 12)])
def test_paged_decode_kernel_at_chunk_edges(cuda, arch, BT):
    """K5 with one row at each of EDGE_POS over shuffled blocks of BT
    tokens (16: TMA boxes of 16 rows; 12: the cp.async path) against its
    plain version, two launches bitwise equal; then, for each edge, K5 with
    two rows at it gives K2's bits over the same KV."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, nh = 2, 4
    nkv, hd = (2, 128) if arch == "llama" else (4, 64)
    h, ffn = nh * hd, 2 * nh * hd
    MB, b = -(-1501 // BT), len(EDGE_POS)
    g = torch.Generator(device=cuda).manual_seed(11)
    p = (_gpt_cuda_params(g, L, h, ffn) if arch == "gpt"
         else _llama_cuda_params(L, h, nh, nkv, ffn, False))
    x = torch.randn(b, h, generator=g, device=cuda).bfloat16()
    pool = torch.randn(L, 1 + b * MB, BT, 2 * nkv * hd, generator=g,
                       device=cuda).bfloat16()
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(2))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32).to(cuda)
    pos = torch.tensor(EDGE_POS, dtype=torch.int32, device=cuda)
    cos, sin = rope_cos_sin(MB * BT, hd, device=cuda)
    rope = lambda q: ((None, None) if arch == "gpt" else
                      (cos.index_select(0, q), sin.index_select(0, q)))
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch)
    xk, pk = fd.fused_paged_decode_cuda(x, p, pool.clone(), tab, pos,
                                        *rope(pos), **kw)
    xk2, pk2 = fd.fused_paged_decode_cuda(x, p, pool.clone(), tab, pos,
                                          *rope(pos), **kw)
    xr, pr = fd.fused_paged_decode_reference(x, p, pool.clone(), tab, pos,
                                             *rope(pos), **kw)
    assert torch.equal(xk, xk2) and torch.equal(pk, pk2)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(pk.float(), pr.float(), atol=5e-2,
                               rtol=2 ** -7)
    cache = torch.stack([pool[:, tab[r].long()].reshape(L, MB * BT, -1)
                         for r in range(2)], dim=1)
    for at in EDGE_POS:
        c2 = (None, None) if arch == "gpt" else (cos[at:at + 1],
                                                 sin[at:at + 1])
        x2, _ = fd.fused_decode_cuda(x[:2], p, cache.clone(), at, *c2, **kw)
        p5 = torch.full((2,), at, dtype=torch.int32, device=cuda)
        x5, _ = fd.fused_paged_decode_cuda(x[:2], p, pool.clone(), tab[:2],
                                           p5, *rope(p5), **kw)
        assert torch.equal(x5, x2), at


@pytest.mark.cuda
def test_moe_decode_kernel_at_chunk_edges(cuda):
    """K6's attention half at each of EDGE_POS over a cache of 1501 rows,
    the gate ×8 (decisive routing): the same expert sets as the plain MoE
    step, x_out and the appended rows at K2's tolerance, two launches
    bitwise equal."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, S, nh, nkv, hd, h, E, f, k = 2, 2, 1501, 4, 4, 128, 512, 16, 256, 2
    g = torch.Generator(device=cuda).manual_seed(12)
    mk = lambda *s, sc=0.05: (torch.randn(*s, generator=g, device=cuda)
                              * sc).bfloat16()
    dq, dkv = nh * hd, nkv * hd
    p = {"ln1": 1 + mk(L, h, sc=0.1), "wqkv": mk(L, h, dq + 2 * dkv),
         "wo": mk(L, dq, h), "ln2": 1 + mk(L, h, sc=0.1),
         "gate": mk(L, E, h, sc=0.4), "weg": mk(L, E, h, f),
         "weu": mk(L, E, h, f), "wed": mk(L, E, f, h)}
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, top_k=k)
    for pos in EDGE_POS:
        x = mk(b, h, sc=1.0)
        kv = mk(L, b, S, 2 * dkv, sc=1.0)
        kv[:, :, pos:] = 0
        c, s = cos[pos:pos + 1], sin[pos:pos + 1]
        kr, pr = {}, {}
        xk, kvk = fd.fused_decode_moe_cuda(x, p, kv.clone(), pos, c, s,
                                           routing=kr, **kw)
        xk2, kvk2 = fd.fused_decode_moe_cuda(x, p, kv.clone(), pos, c, s,
                                             **kw)
        xr, kvr = fd.fused_decode_reference(x, p, kv.clone(), pos, c, s,
                                            arch="moe", routing=pr, **kw)
        assert torch.equal(xk, xk2) and torch.equal(kvk, kvk2), pos
        assert torch.equal(kr["ids"].long().sort(-1).values,
                           pr["ids"].sort(-1).values), pos
        torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                                   rtol=2 ** -7, msg=f"pos {pos}")
        torch.testing.assert_close(kvk.float(), kvr.float(), atol=5e-2,
                                   rtol=2 ** -7, msg=f"pos {pos}")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 33, 64, 65])
@pytest.mark.parametrize("w8", [False, True])
def test_decode_kernels_take_wide_rows(cuda, b, w8):
    """K2 at b = 16, 33, 64 and 65 rows (the product engine's N of 16, 64
    and 64; 65 rows run as two launches of 33 and 32), bf16 and int8
    weights, against its plain version, five launches bitwise equal (int8: at these widths the down product's units are one
    stage each, so half the consumer groups store zero partials with no
    stage to wait on, while the SwiGLU epilogue before it may still read
    the same workspace); with bf16 weights also K5 over a shuffled table
    against its plain version and, every row at one position over the same
    KV, bitwise against K2."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, S, nh, nkv, hd, pos, BT = 2, 256, 8, 2, 64, 150, 16
    MB = S // BT
    h, ffn = nh * hd, 3 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(b)
    p = _llama_cuda_params(L, h, nh, nkv, ffn, w8)
    x = torch.randn(b, h, generator=g, device=cuda).bfloat16()
    kv = torch.randn(L, b, S, 2 * nkv * hd, generator=g,
                     device=cuda).bfloat16()
    kv[:, :, pos:] = 0
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    c, s = cos[pos:pos + 1], sin[pos:pos + 1]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xk, kvk = fd.fused_decode_cuda(x, p, kv.clone(), pos, c, s, **kw)
    for _ in range(4):
        xk2, _ = fd.fused_decode_cuda(x, p, kv.clone(), pos, c, s, **kw)
        assert torch.equal(xk, xk2)
    xr, kvr = fd.fused_decode_reference(x, p, kv.clone(), pos, c, s, **kw)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(kvk.float(), kvr.float(), atol=5e-2,
                               rtol=2 ** -7)
    if w8:
        return
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(b))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32).to(cuda)
    pool = torch.zeros(L, 1 + b * MB, BT, 2 * nkv * hd, dtype=torch.bfloat16,
                       device=cuda)
    for r in range(b):
        pool[:, tab[r].long()] = kv[:, r].reshape(L, MB, BT, -1)
    p5 = torch.randint(0, pos + 1, (b,), generator=torch.Generator()
                       .manual_seed(b), dtype=torch.int32).to(cuda)
    c5, s5 = cos.index_select(0, p5), sin.index_select(0, p5)
    x5, pk = fd.fused_paged_decode_cuda(x, p, pool.clone(), tab, p5, c5, s5,
                                        **kw)
    xr5, pr = fd.fused_paged_decode_reference(x, p, pool.clone(), tab, p5,
                                              c5, s5, **kw)
    torch.testing.assert_close(x5.float(), xr5.float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(pk.float(), pr.float(), atol=5e-2,
                               rtol=2 ** -7)
    at = torch.full((b,), pos, dtype=torch.int32, device=cuda)
    xs, pool = fd.fused_paged_decode_cuda(x, p, pool, tab, at,
                                          cos.index_select(0, at),
                                          sin.index_select(0, at), **kw)
    assert torch.equal(xs, xk)


@pytest.mark.cuda
@pytest.mark.parametrize("step,b", [("decode", 8), ("decode", 16),
                                    ("decode", 64), ("verify", 2),
                                    ("verify", 8)])
def test_int8_engine_repeats_its_bits(cuda, step, b):
    """K2 at b rows and K7 at b slots × 5 tokens with int8 weights at
    Llama-2-7B's widths (2 layers, GQA 4): the product engine's N of 8, 16
    and 64, whose int8 rings hold 8, 7 and 4 stages. 300 launches give the
    first launch's x_out bits. (Each int8 ring stage belongs to one
    consumer pair by its index: a pair that skipped a fill of one of its
    stages could pass its parity wait on a later fill still in flight,
    read and release the wrong tile, and in time leave the ring unfilled.)"""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, S, nh, nkv, hd, K1, BT = 2, 640, 32, 8, 128, 5, 16
    h, dkv2 = nh * hd, 2 * nkv * hd
    p = _llama_cuda_params(L, h, nh, nkv, 11008, True)
    g = torch.Generator(device=cuda).manual_seed(b)
    randn = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    cos, sin = rope_cos_sin(S, hd, device=cuda)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    if step == "decode":
        pos = 600
        x, kv = randn(b, h), randn(L, b, S, dkv2)
        kv[:, :, pos:] = 0
        call = lambda: fd.fused_decode_cuda(x, p, kv, pos, cos[pos:pos + 1],
                                            sin[pos:pos + 1], **kw)[0]
    else:
        MB = S // BT
        x, pool = randn(b, K1, h), randn(L, 1 + b * MB, BT, dkv2)
        perm = torch.randperm(b * MB, generator=torch.Generator()
                              .manual_seed(b))
        tab = (perm.reshape(b, MB) + 1).to(torch.int32).to(cuda)
        pos = torch.randint(0, S - K1, (b,), generator=g, device=cuda,
                            dtype=torch.int32)
        pj = pos.long()[:, None] + torch.arange(K1, device=cuda)[None]
        call = lambda: fd.fused_paged_verify_cuda(x, p, pool, tab, pos,
                                                  cos[pj], sin[pj], **kw)[0]
    first = call().clone()
    differing = sum(int(not torch.equal(call(), first)) for _ in range(300))
    assert differing == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_kernel_matches_plain(cuda, dtype, d):
    """K8 against the plain rms_norm at widths of both its kernels (one
    pass up to 4096 bf16 / 2048 fp32, two passes above): bf16 within two
    bf16 ulp (2^-6 relative: the normalised value may round on either side
    of a boundary, and the weight product rounds again), fp32 within 1e-5
    relative (rsqrtf and the sum order)."""
    from paddle_tpu_torch.ops import rms_norm as rn
    g = torch.Generator(device=cuda).manual_seed(9)
    x = (torch.randn(3, 70, d, generator=g, device=cuda) * 2).to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(dtype)
    n0 = rn.rms_norm_cuda.launches
    for weight in (w, None):
        out = rn.rms_norm_cuda(x, weight, 1e-5)
        ref = rn.rms_norm(x, weight, 1e-5)
        rtol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6,
                                   rtol=rtol)
    assert rn.rms_norm_cuda.launches == n0 + 2
    with pytest.raises(ValueError, match="d % 8"):
        rn.rms_norm_cuda(torch.zeros(2, 12, dtype=torch.bfloat16,
                                     device=cuda))


@pytest.mark.cuda
def test_smem_probe_reads_the_opt_in_budget(cuda):
    """K9: the probe equals the device's opt-in shared memory per block,
    a launch at it runs and one a step above is refused."""
    from paddle_tpu_torch.ops import smem_probe
    got = smem_probe.probe_usable_smem_bytes(cuda)
    optin = getattr(torch.cuda.get_device_properties(cuda),
                    "shared_memory_per_block_optin", got)
    assert got == optin > 48 * 1024
    assert smem_probe.smem_probe_cuda(got, cuda)
    assert not smem_probe.smem_probe_cuda(got + smem_probe.STEP, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_paged_verify_kernel_takes_wide_rows(cuda, arch):
    """K7 at 16 slots x a 5-token tail (80 tail rows: two launches of 8
    slots) against its plain version over a shuffled table, the last slot
    idle: x_out of every token, the appended rows, the rest of the pool
    untouched; two steps bitwise equal; one launch per group."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, K1, nh, nkv, hd, BT, MB = 2, 16, 5, 4, 2, 64, 16, 8
    h, ffn = nh * hd, 3 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(16)
    if arch == "gpt":
        nkv = nh
        p = _gpt_cuda_params(g, L, h, ffn)
    else:
        p = _llama_cuda_params(L, h, nh, nkv, ffn, False)
    x = torch.randn(b, K1, h, generator=g, device=cuda).bfloat16()
    pool = torch.randn(L, 1 + b * MB, BT, 2 * nkv * hd, generator=g,
                       device=cuda).bfloat16()
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(2))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32)
    tab[-1] = 0
    tab = tab.to(cuda)
    positions = np.random.RandomState(3).randint(0, MB * BT - K1, b)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    c = s = None
    if arch == "llama":
        cos, sin = rope_cos_sin(MB * BT, hd, device=cuda)
        pj = pos.long()[:, None] + torch.arange(K1, device=cuda)[None]
        c, s = cos[pj], sin[pj]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch)
    n0 = fd.fused_paged_verify_cuda.launches
    xk, pk = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos, c, s,
                                        **kw)
    assert fd.fused_paged_verify_cuda.launches - n0 == 2
    xk2, pk2 = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos, c,
                                          s, **kw)
    assert torch.equal(xk[:-1], xk2[:-1])
    assert torch.equal(pk[:, 1:], pk2[:, 1:])
    xr, pr = fd.fused_paged_verify_reference(x, p, pool.clone(), tab, pos,
                                             c, s, **kw)
    torch.testing.assert_close(xk[:-1].float(), xr[:-1].float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(pk[:, 1:].float(), pr[:, 1:].float(),
                               atol=5e-2, rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("BT", [8, 12, 48])
def test_paged_verify_kernel_takes_any_block_tokens(cuda, BT):
    """K7's attention loads a stage's keys by TMA boxes of gcd(BT, 64)
    rows when BT is a multiple of 8 (8, 48), else by cp.async (12); either
    way against the plain verify, tails crossing pool blocks, the last row
    idle; two steps bitwise equal."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, K1, nh, nkv, hd = 2, 4, 5, 4, 2, 128
    h, ffn = nh * hd, 2 * nh * hd
    MB = 600 // BT
    g = torch.Generator(device=cuda).manual_seed(BT)
    p = _llama_cuda_params(L, h, nh, nkv, ffn, False)
    x = torch.randn(b, K1, h, generator=g, device=cuda).bfloat16()
    pool = torch.randn(L, 1 + b * MB, BT, 2 * nkv * hd, generator=g,
                       device=cuda).bfloat16()
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(3))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32)
    tab[-1] = 0
    tab = tab.to(cuda)
    positions = [MB * BT - 1 - K1 - 3 * BT, 2 * BT - 2, 513, 7]
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    cos, sin = rope_cos_sin(MB * BT, hd, device=cuda)
    pj = pos.long()[:, None] + torch.arange(K1, device=cuda)[None]
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5)
    xk, pk = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos,
                                        cos[pj], sin[pj], **kw)
    xk2, pk2 = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos,
                                          cos[pj], sin[pj], **kw)
    assert torch.equal(xk[:-1], xk2[:-1])
    assert torch.equal(pk[:, 1:], pk2[:, 1:])
    xr, pr = fd.fused_paged_verify_reference(x, p, pool.clone(), tab, pos,
                                             cos[pj], sin[pj], **kw)
    torch.testing.assert_close(xk[:-1].float(), xr[:-1].float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(pk[:, 1:].float(), pr[:, 1:].float(),
                               atol=5e-2, rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [9, 16])
def test_moe_decode_kernel_takes_wide_rows(cuda, b):
    """K6 at b = 9 and 16 rows (two launches of rows, top-2 of 8 experts)
    against its plain version taking K6's experts, two steps bitwise
    equal, the routing of every row returned."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    m = _tiny_moe(hidden_size=128, num_heads=2, num_kv_heads=1)
    m = m.to(cuda)
    params = {k: v.to(cuda) for k, v in fd.build_fused_params_moe(
        m.state_dict(include_buffers=False), 2).items()}
    g = torch.Generator(device=cuda).manual_seed(b)
    S, pos = 64, 40
    x = torch.randn(b, 128, generator=g, device=cuda).bfloat16()
    kv = torch.randn(2, b, S, 2 * 64, generator=g, device=cuda).bfloat16()
    kv[:, :, pos:] = 0
    cos, sin = rope_cos_sin(S, 64, device=cuda)
    kw = dict(num_heads=2, num_kv_heads=1, eps=1e-5, top_k=2)
    rk, rk2 = {}, {}
    n0 = fd.fused_decode_moe_cuda.launches
    xk, kvk = fd.fused_decode_moe_cuda(x, params, kv.clone(), pos,
                                       cos[pos:pos + 1], sin[pos:pos + 1],
                                       routing=rk, **kw)
    assert fd.fused_decode_moe_cuda.launches - n0 == 2
    xk2, kvk2 = fd.fused_decode_moe_cuda(x, params, kv.clone(), pos,
                                         cos[pos:pos + 1], sin[pos:pos + 1],
                                         routing=rk2, **kw)
    assert torch.equal(xk, xk2) and torch.equal(kvk, kvk2)
    assert tuple(rk["ids"].shape) == (2, b, 2)
    assert torch.equal(rk["ids"], rk2["ids"])
    forced = {"force_ids": rk["ids"].long()}
    xr, kvr = fd.fused_decode_reference(x, params, kv.clone(), pos,
                                        cos[pos:pos + 1], sin[pos:pos + 1],
                                        arch="moe", routing=forced, **kw)
    torch.testing.assert_close(xk.float(), xr.float(), atol=5e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(kvk.float(), kvr.float(), atol=5e-2,
                               rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("slots,k", [(65, 0), (16, 4)])
def test_wide_engines_run_on_the_card(cuda, slots, k):
    """ServingEngine at 65 slots (K5 in two launches a tick) and at 16
    slots speculating k = 4 (K7 in two launches a tick) on a tiny llama:
    every slot busy at once, every request at its full length, the
    launches as the row groups say, no leaked block."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2)
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda",
                             seed=0)
    eng = ServingEngine(model, max_slots=slots, block_tokens=16,
                        max_seq_len=64, device="cuda",
                        speculate=SpecConfig(k=k) if k else None)
    r = np.random.RandomState(slots)
    reqs = [(r.randint(0, 256, int(n)), int(m)) for n, m in
            zip(r.randint(4, 24, slots), r.randint(3, 9, slots))]
    fd.fused_paged_decode_cuda.launches = 0
    fd.fused_paged_verify_cuda.launches = 0
    rids = [eng.submit(Request(p, max_new_tokens=m)) for p, m in reqs]
    eng.step()
    assert eng.active_slots == slots
    eng.drain(max_steps=200)
    assert [len(eng.results[i].tokens) for i in rids] == [m for _, m in reqs]
    st = eng.stats
    groups = len(fd.row_groups(slots, fd.GROUP_ROWS // (k + 1)))
    assert groups == 2
    if k:
        assert fd.fused_paged_verify_cuda.launches == \
            groups * st["spec_ticks"] > 0
        assert fd.fused_paged_decode_cuda.launches == \
            st["steps"] - st["spec_ticks"] + st["replay_tokens"]
    else:
        assert fd.fused_paged_decode_cuda.launches == \
            groups * (st["steps"] + st["replay_tokens"])
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0


def _per_row_scales(pool_bf16, tab, nkv):
    """An int8 pool from a bf16 one with per-ROW lane scales (L, b,
    2*nkv*hd): row r's scales calibrated over its own blocks, as a serving
    slot's are over its prompt; blocks no row owns quantized with the
    first row's."""
    from paddle_tpu_torch.ops import fused_decode as fd
    L, b = pool_bf16.shape[0], tab.shape[0]
    lanes = torch.stack([fd.quantize_kv_cache(
        pool_bf16[:, tab[r].long()].reshape(L, 1, -1, pool_bf16.shape[3]),
        nkv)[1][:, 0] for r in range(b)], dim=1)
    pool = torch.clamp(torch.round(pool_bf16.float() / lanes[:, 0, None,
                                                             None]),
                       -127, 127).to(torch.int8)
    for r in range(b):
        bids = tab[r].long()
        pool[:, bids] = torch.clamp(torch.round(
            pool_bf16[:, bids].float() / lanes[:, r, None, None]), -127,
            127).to(torch.int8)
    return pool, lanes.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("BT", [16, 12])
@pytest.mark.parametrize("w8,kv8", [(True, False), (False, True),
                                    (True, True)])
def test_paged_decode_int8_modes_match_plain(cuda, w8, kv8, BT):
    """K5's int8 modes (llama) at each of EDGE_POS plus an idle row, over
    shuffled blocks of BT tokens (16: TMA boxes; 12: the cp.async path):
    x_out of the active rows at K2's tolerance, the appended int8 rows
    within one int8 step, two launches bitwise equal; and with every row's
    scales equal to K2's layer scales, K5 gives K2-int8's bits."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, nh, nkv, hd = 2, 8, 2, 64
    h, ffn = nh * hd, 3 * nh * hd
    MB, b = -(-1501 // BT), len(EDGE_POS) + 1
    g = torch.Generator(device=cuda).manual_seed(21)
    p = _llama_cuda_params(L, h, nh, nkv, ffn, w8)
    x = torch.randn(b, h, generator=g, device=cuda).bfloat16()
    pool = torch.randn(L, 1 + b * MB, BT, 2 * nkv * hd, generator=g,
                       device=cuda).bfloat16()
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(3))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32).to(cuda)
    tab[-1] = 0                                       # an idle row
    sc = None
    if kv8:
        pool, sc = _per_row_scales(pool, tab, nkv)
    pos = torch.tensor(EDGE_POS + (5,), dtype=torch.int32, device=cuda)
    cos, sin = rope_cos_sin(MB * BT, hd, device=cuda)
    c, s = cos.index_select(0, pos), sin.index_select(0, pos)
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, kv_scales=sc)
    xk, pk = fd.fused_paged_decode_cuda(x, p, pool.clone(), tab, pos, c, s,
                                        **kw)
    xk2, pk2 = fd.fused_paged_decode_cuda(x, p, pool.clone(), tab, pos, c,
                                          s, **kw)
    xr, pr = fd.fused_paged_decode_reference(x, p, pool.clone(), tab, pos,
                                             c, s, **kw)
    assert torch.equal(xk, xk2) and torch.equal(pk, pk2)
    torch.testing.assert_close(xk[:-1].float(), xr[:-1].float(), atol=5e-2,
                               rtol=2 ** -7)
    if kv8:
        assert (pk[:, 1:].int() - pr[:, 1:].int()).abs().max() <= 1
    else:
        torch.testing.assert_close(pk[:, 1:].float(), pr[:, 1:].float(),
                                   atol=5e-2, rtol=2 ** -7)
    if not kv8:
        return
    # the pin: every row's scales K2's layer scales -> K2-int8's bits
    cache8, lanes = fd.quantize_kv_cache(torch.stack(
        [pool[:, tab[r].long()].reshape(L, MB * BT, -1).float()
         for r in range(2)], dim=1), nkv)
    pool2 = pool.clone()
    for r in range(2):
        pool2[:, tab[r].long()] = cache8[:, r].reshape(L, MB, BT, -1)
    for at in (511, 1024):
        x2, _ = fd.fused_decode_cuda(x[:2], p, cache8.clone(), at,
                                     cos[at:at + 1], sin[at:at + 1],
                                     num_heads=nh, num_kv_heads=nkv,
                                     kv_scales=lanes)
        p5 = torch.full((2,), at, dtype=torch.int32, device=cuda)
        x5, _ = fd.fused_paged_decode_cuda(
            x[:2], p, pool2.clone(), tab[:2], p5, cos.index_select(0, p5),
            sin.index_select(0, p5), num_heads=nh, num_kv_heads=nkv,
            kv_scales=lanes.expand(L, 2, -1).contiguous())
        assert torch.equal(x5, x2), at


@pytest.mark.cuda
@pytest.mark.parametrize("arch,w8", [("llama", True), ("llama", False),
                                     ("gpt", False)])
def test_paged_verify_int8_pool_matches_plain(cuda, arch, w8):
    """K7 over an int8 pool with per-row scales (llama with int8 weights or
    bf16 ones, gpt): 16 slots x 5 tail rows (two launches), one slot idle;
    mapped tail rows at K7's tolerance, the appended int8 rows within one
    int8 step, two launches bitwise equal."""
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.ops.rope import rope_cos_sin
    L, b, K1, BT, MB = 2, 16, 5, 16, 8
    nh, nkv, hd = (8, 2, 64) if arch == "llama" else (4, 4, 64)
    h, ffn = nh * hd, 2 * nh * hd
    g = torch.Generator(device=cuda).manual_seed(22)
    p = (_gpt_cuda_params(g, L, h, ffn) if arch == "gpt"
         else _llama_cuda_params(L, h, nh, nkv, ffn, w8))
    x = torch.randn(b, K1, h, generator=g, device=cuda).bfloat16()
    pool = torch.randn(L, 1 + b * MB, BT, 2 * nkv * hd, generator=g,
                       device=cuda).bfloat16()
    perm = torch.randperm(b * MB, generator=torch.Generator().manual_seed(4))
    tab = (perm.reshape(b, MB) + 1).to(torch.int32).to(cuda)
    tab[-1] = 0
    pool, sc = _per_row_scales(pool, tab, nkv)
    pos = torch.randint(0, MB * BT - K1, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    cos, sin = rope_cos_sin(MB * BT, hd, device=cuda)
    pj = pos.long()[:, None] + torch.arange(K1, device=cuda)[None]
    rope = (None, None) if arch == "gpt" else (cos[pj], sin[pj])
    kw = dict(num_heads=nh, num_kv_heads=nkv, eps=1e-5, arch=arch,
              kv_scales=sc)
    fd.fused_paged_verify_cuda.launches = 0
    xk, pk = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos, *rope,
                                        **kw)
    assert fd.fused_paged_verify_cuda.launches == 2
    xk2, pk2 = fd.fused_paged_verify_cuda(x, p, pool.clone(), tab, pos,
                                          *rope, **kw)
    xr, pr = fd.fused_paged_verify_reference(x, p, pool.clone(), tab, pos,
                                             *rope, **kw)
    assert torch.equal(xk, xk2) and torch.equal(pk, pk2)
    torch.testing.assert_close(xk[:-1].float(), xr[:-1].float(), atol=5e-2,
                               rtol=2 ** -7)
    assert (pk[:, 1:].int() - pr[:, 1:].int()).abs().max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch,w8,k", [("llama", True, 0), ("llama", True, 4),
                                       ("gpt", False, 0)])
def test_int8_engines_run_on_the_card(cuda, arch, w8, k):
    """ServingEngine with an int8 pool (llama also with int8 weights) on
    the card, plain and speculating k = 4: every request at its full
    length through K5's (K7's) int8 modes, no leaked block."""
    from paddle_tpu_torch.models import (GPTConfig, GPTPretrainModel,
                                         LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.ops import fused_decode as fd
    from paddle_tpu_torch.quantization import quantize_model
    from paddle_tpu_torch.serving import Request, ServingEngine, SpecConfig
    if arch == "gpt":
        model = GPTPretrainModel(GPTConfig(
            vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
            max_position_embeddings=256, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0), dtype=torch.bfloat16,
            device="cuda", seed=0)
        model.eval()
    else:
        model = LlamaForCausalLM(LlamaConfig(
            vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2),
            dtype=torch.bfloat16, device="cuda", seed=0)
        if w8:
            quantize_model(model)
    eng = ServingEngine(model, max_slots=4, block_tokens=16, max_seq_len=128,
                        device="cuda", cache_dtype=torch.int8,
                        speculate=SpecConfig(k=k) if k else None)
    r = np.random.RandomState(7)
    reqs = [(r.randint(0, 256, int(n)), int(m)) for n, m in
            zip(r.randint(4, 40, 6), r.randint(3, 12, 6))]
    fd.fused_paged_decode_cuda.launches = 0
    fd.fused_paged_verify_cuda.launches = 0
    rids = [eng.submit(Request(p, max_new_tokens=m)) for p, m in reqs]
    eng.drain(max_steps=200)
    assert [len(eng.results[i].tokens) for i in rids] == [m for _, m in reqs]
    st = eng.stats
    assert fd.fused_paged_verify_cuda.launches == st["spec_ticks"]
    assert fd.fused_paged_decode_cuda.launches == \
        st["steps"] - st["spec_ticks"] + st["replay_tokens"]
    assert (st["spec_ticks"] if k else st["steps"]) > 0
    eng.prefix_cache.clear()
    assert eng.pool.used_blocks == 0
