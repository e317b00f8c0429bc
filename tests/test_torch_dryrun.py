"""The port's dry run on the CPU: the shape cells and architecture registry,
the op walk's accounting and overlap classifier, the roofline, the kernels'
fake-tensor paths, and a cell traced on a fake world.

Twins of ``tests/test_system.py:16`` and ``:24`` and of
``tests/test_dryrun_local.py:6``, ``:171``, ``:241``, ``:326`` and ``:404``:
the reference walks optimized HLO text, the port walks one rank's eager op
stream (``repro_torch.launch.op_walk``), so the hand-built programs are op
streams.  Every fake world is ended at the end of its test: a later test in
the same process may start a real one.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax  # noqa: F401  (the reference package's configs import it)

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.configs import SHAPES, ShapeCell
from repro_torch.core.dist import init_fake_world, make_mesh
from repro_torch.kernels import work
from repro_torch.kernels.fake import CardTrace, card_trace
from repro_torch.launch import dryrun, op_walk
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_walk import Collective, Op, OpStream, analyze, plan_agreement
from repro_torch.models import lm
from repro_torch.models.sharding import local_batch, make_recipe
from repro_torch.models.weights import shard_params_by_recipe
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_train_step

from _torch_dist import run_gloo


@pytest.fixture
def world():
    """Ends whatever world a test started."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ configs ----

def test_shape_cells_cover_assignment():
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k", "long_500k"}
    assert SHAPES["train_4k"].seq_len == 4096 and SHAPES["train_4k"].global_batch == 256
    assert SHAPES["prefill_32k"].seq_len == 32768 and SHAPES["prefill_32k"].global_batch == 32
    assert SHAPES["decode_32k"].global_batch == 128
    assert SHAPES["long_500k"].seq_len == 524288 and SHAPES["long_500k"].global_batch == 1
    for name, cell in SHAPES.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(ref_configs.SHAPES[name])
    from repro_torch.data.pipeline import ShapeCell as PipelineCell

    assert PipelineCell is ShapeCell


def test_all_ten_archs_registered():
    assert len(configs.ARCH_IDS) == 10
    assert sorted(configs.ARCH_IDS) == sorted(ref_configs.ARCH_IDS)
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        smoke = configs.get(arch, smoke=True)
        assert cfg.family == smoke.family, arch
        assert smoke.d_model <= 128, "smoke configs must be reduced"
        ref = ref_configs.get(arch)
        assert cfg.sub_quadratic == ref.sub_quadratic, arch
        assert cfg.supported_shapes() == ref.supported_shapes(), arch
        assert cfg.param_count() == ref.param_count(), arch
        assert cfg.param_count(active_only=True) == ref.param_count(active_only=True), arch
    cells = list(dryrun.iter_cells())
    assert len(cells) == 40 and sum(s == "run" for *_, s in cells) == 32


# -------------------------------------------------------- cell tracing ----

def test_lower_compile_and_roofline_smoke(world):
    """The small twin of the production dry run: phi4-mini's smoke step on
    a fake (4, 2) world, rank 0's program traced on fake tensors of the
    card (head dim 64, one of the attention kernel's): the walk finds
    operations, bytes and collectives, and the roofline's terms."""
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), head_dim=64)
    cell = ShapeCell("t", seq_len=128, global_batch=8, kind="train")
    init_fake_world(8, 0, "cpu")
    mode, dev = card_trace("cuda")
    mesh = make_mesh((4, 2), ("data", "model"), device=dev)
    recipe = make_recipe(cfg, mesh)
    ocfg = OptConfig()
    with mode:
        params = lm.abstract_model(cfg, recipe=recipe, device=dev)
        opt = init_opt_state(params, ocfg)
        batch = local_batch(recipe, {k: torch.empty((8, 128), dtype=torch.int32, device=dev)
                                     for k in ("tokens", "labels")})
        with op_walk.OpWalk() as walk:
            make_train_step(cfg, recipe, ocfg)(params, opt, batch)
    st = walk.stats()
    assert st.flops > 0 and st.bytes > 0 and st.collective_bytes > 0, st.coll_by_op
    assert st.peak_live_bytes > 0
    # forward and remat's recompute of every layer through the kernel
    assert st.kernel_launches == {"flash_attention_kernel": 2 * cfg.n_layers}
    assert {"all-gather", "all-reduce"} <= set(st.coll_by_op)
    # every collective of the recipe runs over a group of this world
    assert all(c.ranks and set(c.ranks) <= set(range(8)) for c in st.collectives)
    rep = rl.roofline_report(arch="phi4-mini-3.8b", shape="t", mesh_name="4x2", chips=8,
                             stats=st, model_flops=dryrun._model_flops(cfg, cell))
    assert rep.t_compute > 0 and rep.t_memory > 0 and rep.t_collective > 0
    assert rep.dominant in ("compute", "memory", "collective")
    assert 0 < rep.useful_ratio


def test_fake_trace_equals_real_gloo_run(world, tmp_path):
    """The fake trace of rank 0's training step issues exactly the ops and
    collectives a real run of the same rank issues on two gloo processes,
    with the same operations, bytes and peak memory: nothing of the fake
    world or the fake tensors changes the program."""
    real = run_gloo("walk_train_step", 2, tmp_path, grid=(1, 2), seq=16, batch=2)[0]
    cfg = configs.get("phi4-mini-3.8b", smoke=True)
    init_fake_world(2, 0, "cpu")
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    recipe = make_recipe(cfg, mesh)
    ocfg = OptConfig()
    with torch._subclasses.fake_tensor.FakeTensorMode():
        params = lm.abstract_model(cfg, recipe=recipe, device="cpu")
        opt = init_opt_state(params, ocfg)
        batch = local_batch(recipe, {k: torch.empty((2, 16), dtype=torch.int32)
                                     for k in ("tokens", "labels")})
        with op_walk.OpWalk() as walk:
            make_train_step(cfg, recipe, ocfg)(params, opt, batch)
    st = walk.stats()
    assert [op.name for op in walk.stream.ops] == real["names"]
    assert [(c.kind, c.bytes, c.ranks) for c in st.collectives] == real["collectives"]
    assert any(k == "all-reduce" for k, *_ in real["collectives"])
    assert st.flops == real["flops"]
    # a scalar operand a fake tensor wraps as a 0-dim tensor adds its bytes,
    # and its storage a block of the peak
    assert abs(st.bytes - real["bytes"]) <= 1e-5 * real["bytes"]
    assert abs(st.peak_live_bytes - real["peak_live_bytes"]) <= 4 * op_walk.BLOCK


@pytest.mark.parametrize("arch,grid", [("phi4-mini-3.8b", (4, 2)),
                                       ("phi3.5-moe-42b-a6.6b", (2, 4)),
                                       ("zamba2-7b", (2, 2))])
def test_abstract_model_bytes_equal_real_shards(world, arch, grid):
    """``lm.abstract_model`` under a recipe makes this rank's shard of every
    leaf and nothing whole: its shapes and bytes are
    ``shard_params_by_recipe``'s of the real weights, on every rank."""
    cfg = configs.get(arch, smoke=True)
    whole = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    for rank in range(int(np.prod(grid))):
        init_fake_world(int(np.prod(grid)), rank, "cpu")
        mesh = make_mesh(grid, ("data", "model"), device="cpu")
        recipe = make_recipe(cfg, mesh)
        real = shard_params_by_recipe(whole, lm.build_specs(cfg), recipe)
        with CardTrace():
            fake = lm.abstract_model(cfg, recipe=recipe, device="cpu")
        pairs = list(zip(dryrun._flat(fake), dryrun._flat(real)))
        assert len(pairs) == len(dryrun._flat(real))
        for f, r in pairs:
            assert f.shape == r.shape and f.dtype == r.dtype
        assert dryrun._nbytes(fake) == dryrun._nbytes(real) < dryrun._nbytes(whole)
        dist.destroy_process_group()


def test_fake_world_refuses_and_is_refused(world):
    """A fake world is this process's alone: ``init_world`` refuses it (it
    runs no real backend), the dry run refuses a real one, and
    ``resolve_device("cuda")`` names the card without asking for one."""
    from repro_torch.core.dist import init_world, is_fake_world, resolve_device

    dev = init_fake_world(4, 1, "cuda")
    assert dev == torch.device("cuda", 0) and is_fake_world()
    assert resolve_device("cuda") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError):
        init_world("cpu")
    with pytest.raises(RuntimeError):
        init_fake_world(4, 0)
    dryrun.fake_world(8, 3)  # a fake world of another size replaces it
    assert dist.get_world_size() == 8 and dist.get_rank() == 3
    dist.destroy_process_group()
    init_world("cpu")
    with pytest.raises(RuntimeError):
        dryrun.fake_world(8)


def test_idle_rows_read_chunk_on_fake_tensors():
    """The decode's one host read answers for the dry run's state on fake
    tensors (every row live: no idle row reads its chunk) instead of
    reading a value a fake tensor does not have."""
    from repro_torch.models.attention import idle_rows_read_chunk

    length = torch.tensor([0, 5, 9], dtype=torch.int32)
    counts = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert idle_rows_read_chunk(length, counts, 16, 1) is True  # row 0 is idle and sees no key
    with CardTrace() as mode:
        fl, fc = mode.from_tensor(length), mode.from_tensor(counts)
        assert idle_rows_read_chunk(fl, fc, 16, 1) is False


def test_tree_unflatten_leaves_no_reference_cycle():
    """``tree_unflatten`` keeps nothing of its leaves once the tree is
    dropped, without the cyclic garbage collector: the dry run's training
    step found the previous step's gradients (a float32 copy of the
    parameters) alive into the next step through a recursive closure."""
    import gc
    import weakref

    from repro_torch.models.module import tree_unflatten

    spec = {"b": {"x": 0, "y": 0}, "a": 0}
    leaves = [torch.zeros(4) for _ in range(3)]
    refs = [weakref.ref(t) for t in leaves]
    gc.disable()
    try:
        tree = tree_unflatten(spec, leaves)
        assert tree["a"] is leaves[0] and tree["b"]["y"] is leaves[2]
        del tree, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ------------------------------------------------------ kernel fake paths ----

def _raise(*_a, **_k):
    raise AssertionError("a fake call loaded a kernel library")


@pytest.mark.parametrize("trace", ["cuda", "card_trace"])
def test_ops_on_fake_tensors_stand_for_their_launches(monkeypatch, trace):
    """Every ``ops`` entry on fake tensors of the card (a ``CardTrace``'s,
    or fake CUDA tensors) returns the kernel's shapes and dtypes, reports
    one launch with the work formula of ``kernels/work.py`` to the walk,
    loads no library and leaves the real launch counts alone."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import gemm, ops, relayout

    for mod, name in ((fa, "load_library"), (fd, "load_library"), (gemm, "load_library"),
                      (gemm, "load_bf16_library"), (relayout, "load_library")):
        monkeypatch.setattr(mod, name, _raise)
    counters = (fa.flash_attention_cuda, fa.flash_attention_carry_cuda, fd.flash_decode_cuda,
                gemm.gemm_cuda, gemm.gemm_panel_cuda, gemm.gemm_bf16_cuda,
                gemm.gemm_panel_bf16_cuda, relayout.transpose_cuda)
    before = [c.launches for c in counters]
    mode = torch._subclasses.fake_tensor.FakeTensorMode() if trace == "cuda" else CardTrace()
    dev = "cuda" if trace == "cuda" else "cpu"
    bf = torch.bfloat16
    with mode, op_walk.OpWalk() as walk:
        a, b = torch.empty((64, 48), device=dev), torch.empty((48, 80), device=dev)
        assert ops.gemm(a, b).shape == (64, 80)
        panel = torch.empty((64, 160), device=dev)
        assert ops.gemm_panel(a, b, panel, 1) is panel
        ab, bb = a.to(bf), b.to(bf)
        c = ops.gemm(ab, bb, out_dtype=torch.float32)
        assert c.shape == (64, 80) and c.dtype == torch.float32
        assert ops.gemm_panel(ab, bb, panel.to(bf), 0).dtype == bf
        q = torch.empty((2, 8, 100, 64), dtype=bf, device=dev)
        kv = torch.empty((2, 2, 100, 64), dtype=bf, device=dev)
        o = ops.flash_attention(q, kv, kv)
        assert o.shape == (2, 8, 100, 64) and o.dtype == bf
        acc, m, l = ops.flash_attention_carry(q, kv, kv, q_offset=100, k_offset=0)
        assert acc.shape == (2, 8, 100, 64) and m.shape == l.shape == (2, 8, 100)
        qd = torch.empty((2, 8, 1, 64), dtype=bf, device=dev)
        cache = torch.empty((2, 2, 512, 64), dtype=bf, device=dev)
        lens = torch.empty((2,), dtype=torch.int32, device=dev)
        assert ops.flash_decode(qd, cache, cache, lens).shape == (2, 8, 1, 64)
        x = torch.empty((3, 256, 128), device=dev)
        assert ops.transpose_tiled(x, bm=128, bn=128).shape == (3, 128, 256)
    st = walk.stats()
    assert [c.launches for c in counters] == before
    assert st.kernel_launches == {
        "layout_gemm_kernel": 1, "layout_gemm_panel_kernel": 1, "layout_gemm_bf16_kernel": 1,
        "layout_gemm_panel_bf16_kernel": 1, "flash_attention_kernel": 1,
        "flash_attention_carry_kernel": 1, "flash_decode_kernel": 1, "transpose_kernel": 1}
    kernels = [op for op in walk.stream.ops if op.kind == "kernel"]
    by_name = {op.name: op for op in kernels}
    gemm_flops, gemm_bytes = work.gemm_work(64, 80, 48, acc=False)
    assert (by_name["layout_gemm_kernel"].flops, by_name["layout_gemm_kernel"].bytes) == \
        (gemm_flops, gemm_bytes)
    fwd = work.flash_attention_work(2, 8, 2, 100, 100, 64, 64, causal=True, dtype=bf,
                                    pieces=fa.P_PIECES)
    op = by_name["flash_attention_kernel"]
    assert (op.flops, op.bytes, op.seconds) == fwd
    # the carry step at q_offset 100 over keys 0..99: every pair visible
    assert by_name["flash_attention_carry_kernel"].flops == 2 * 8 * 100 * 100 * (64 + 64) * 2
    assert by_name["transpose_kernel"].bytes == 2 * 3 * 256 * 128 * 4


def test_kernels_report_to_an_observer_and_import_nothing_of_launch():
    """The kernel layer reports fake launches to an observer that the walk
    registers (and restores on exit, nested walks too); with none, a report
    goes nowhere.  No module of ``repro_torch.kernels`` imports
    ``repro_torch.launch``."""
    import ast
    import pathlib

    from repro_torch.kernels import fake

    assert fake.set_observer(None) is None
    fake.report("transpose_kernel", (), (), (0.0, 8.0, 0.0))  # no observer: nothing
    with op_walk.OpWalk() as outer:
        with op_walk.OpWalk() as inner:
            assert fake.set_observer(inner) is inner
            fake.report("transpose_kernel", (), (), (0.0, 8.0, 0.0))
        fake.report("transpose_kernel", (), (), (0.0, 16.0, 0.0))
    assert fake.set_observer(None) is None
    assert [op.bytes for op in inner.stream.ops] == [8.0]
    assert [op.bytes for op in outer.stream.ops] == [16.0]

    kernels = pathlib.Path(fake.__file__).parent
    for path in sorted(kernels.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.startswith("repro_torch.launch") for n in names), path.name


def test_decode_plan_on_fake_tensors_matches_the_python_sizes():
    """A fake decode call plans its splits with the H100's SM count and the
    Python twin of the library's shared-memory size, and allocates the
    partials the launch would."""
    from repro_torch.kernels import flash_decode as fd

    tr, splits, per = fd.plan_launch(8, 2 * 2, 1, 64, 512, fd.H100_SMS,
                                      lambda D, tr, bk: fd.smem_bytes(D, tr, bk, 64))
    with CardTrace(), op_walk.OpWalk() as walk:
        q = torch.empty((2, 8, 1, 64), dtype=torch.bfloat16)
        cache = torch.empty((2, 2, 512, 64), dtype=torch.bfloat16)
        fd.flash_decode_cuda(q, cache, cache, torch.empty((2,), dtype=torch.int32))
    empties = [op for op in walk.stream.ops if op.kind == "alloc"]
    assert splits >= 1 and len(empties) >= 4  # out, o_part, m_part, l_part
    assert walk.stats().kernel_launches == {"flash_decode_kernel": 1}


# ---------------------------------------------------- hand-built streams ----

def _stream(ops, colls):
    st = OpStream()
    for op in ops:
        st.add(op)
    st.collectives = colls
    return st


def _mm(reads, writes):
    return Op("aten.mm", "compute", tuple(reads), tuple(writes), flops=2.0 * 8 ** 3)


def _coll(kind, op, issue, wait, nbytes=8 * 8 * 4):
    return Collective(kind, nbytes, (op,), issue, wait)


def test_permute_classification_hand_built_stream():
    """A permute fed by an mm whose result the next mm reads, waited at
    once, is serialized; one fed from a parameter is overlapped; the same
    chain with an mm issued inside the permute's window is overlapped."""
    # storages: 0, 1 parameters; 2 mm out; 3 permute out; 4 mm out; 5 permute out
    ops = [_mm((0, 1), (2,)),
           Op("c10d.send", "collective", (2,), ()), Op("c10d.recv_", "collective", (2,), (3,)),
           _mm((3, 1), (4,)),
           Op("c10d.send", "collective", (1,), ()), Op("c10d.recv_", "collective", (1,), (5,)),
           Op("aten.add", "compute", (4, 5), (6,))]
    colls = [Collective("collective-permute", 256, (1, 2), 1, 3),
             Collective("collective-permute", 256, (4, 5), 4, 6)]
    st = analyze(_stream(ops, colls))
    assert [c.classification for c in st.collectives] == ["serialized", "overlapped"]
    kind = "collective-permute"
    assert st.collectives_serialized(kind) == 1 and st.collectives_overlapped(kind) == 1
    assert st.overlap_fraction(kind) == 0.5
    assert st.flops == 2 * 2.0 * 8 ** 3
    # the first permute again, waited after an independent mm: the window hid it
    ops2 = [_mm((0, 1), (2,)),
            Op("c10d.send", "collective", (2,), ()), Op("c10d.recv_", "collective", (2,), (3,)),
            _mm((0, 0), (7,)),
            _mm((3, 1), (4,))]
    st2 = analyze(_stream(ops2, [Collective("collective-permute", 256, (1, 2), 1, 4)]))
    assert st2.collectives[0].classification == "overlapped"
    # a blocking transfer between two dependent mms through a copy: serialized
    ops3 = [_mm((0, 1), (2,)), Op("aten.clone", "copy", (2,), (8,)),
            Op("c10d.allreduce_", "collective", (8,), (8,)),
            Op("aten.clone", "copy", (8,), (9,)), _mm((9, 1), (4,))]
    st3 = analyze(_stream(ops3, [_coll("all-reduce", 2, 2, 3)]))
    assert st3.collectives[0].classification == "serialized"


def test_collective_classification_kind_generic_hand_built_stream():
    """The verdict does not depend on the kind: an all-gather on an
    mm -> mm chain with an empty window is serialized like a permute; with
    a sibling mm in its window it is overlapped; nothing reading its result
    with compute (a terminal gather) is overlapped.  Per-kind stats: the
    all-reduce counts twice, exposed bytes, overlap fractions."""
    chain = [_mm((0, 1), (2,)), Op("c10d._allgather_base_", "collective", (2,), (3,)),
             _mm((3, 1), (4,))]
    st = analyze(_stream(chain, [_coll("all-gather", 1, 1, 2)]))
    assert [(c.kind, c.classification) for c in st.collectives] == [("all-gather", "serialized")]
    sibling = [_mm((0, 1), (2,)), Op("c10d._allgather_base_", "collective", (2,), (3,)),
               _mm((2, 0), (5,)), _mm((3, 1), (4,))]
    st = analyze(_stream(sibling, [_coll("all-gather", 1, 1, 3)]))
    assert st.collectives[0].classification == "overlapped"
    terminal = [_mm((0, 1), (2,)), Op("c10d._allgather_base_", "collective", (2,), (3,)),
                Op("aten.clone", "copy", (3,), (6,))]
    st = analyze(_stream(terminal, [_coll("all-gather", 1, 1, 2)]))
    assert st.collectives[0].classification == "overlapped"

    mixed = [_mm((0, 1), (2,)), Op("c10d.allreduce_", "collective", (2,), (2,)),
             _mm((2, 1), (4,)),
             Op("c10d.send", "collective", (1,), ()), Op("c10d.recv_", "collective", (1,), (5,)),
             Op("aten.add", "compute", (4, 5), (6,))]
    st = analyze(_stream(mixed, [_coll("all-reduce", 1, 1, 2),
                                 Collective("collective-permute", 256, (3, 4), 3, 5)]))
    tb = 8 * 8 * 4
    assert st.collectives_serialized() == 1 and st.collectives_overlapped() == 1
    assert st.exposed_collective_bytes() == 2 * tb  # all-reduce factor x2
    by_kind = st.overlap_by_kind()
    assert by_kind["all-reduce"]["serialized"] == 1
    assert by_kind["all-reduce"]["exposed_bytes"] == 2 * tb
    assert by_kind["collective-permute"]["overlapped"] == 1
    assert by_kind["collective-permute"]["exposed_bytes"] == 0.0
    assert abs(st.overlap_fraction() - 1.0 / 3.0) < 1e-12
    assert st.collective_bytes == 3 * tb and st.coll_by_op == {"all-reduce": 2 * tb,
                                                               "collective-permute": tb}
    assert plan_agreement(st, "overlapped") == {
        "declared": "overlapped", "proven": "serialized", "agree": False,
        "serialized": 1, "overlapped": 1}
    assert plan_agreement(st, "overlapped", kind="collective-permute")["agree"]


def test_valid_fractions_discount_padding():
    """``valid_fractions`` scales the payload and exposed bytes of its kind;
    the wire figures stay exact, other kinds untouched, bad entries
    refused."""
    ops = [_mm((0, 1), (2,)),
           Op("c10d.send", "collective", (2,), ()), Op("c10d.recv_", "collective", (2,), (3,)),
           Op("c10d._allgather_base_", "collective", (3,), (4,)),
           _mm((4, 1), (5,))]

    def colls():
        return [Collective("collective-permute", 256, (1, 2), 1, 3),
                _coll("all-gather", 3, 3, 4)]

    tb = 8 * 8 * 4
    dense = analyze(_stream(ops, colls()))
    ragged = analyze(_stream(ops, colls()), valid_fractions={"collective-permute": 0.75})
    assert ragged.collective_bytes == dense.collective_bytes == 2 * tb
    assert ragged.coll_by_op == dense.coll_by_op
    assert dense.valid_collective_bytes == 2 * tb
    assert ragged.valid_collective_bytes == 0.75 * tb + tb
    assert ragged.coll_by_op_valid["collective-permute"] == 0.75 * tb
    assert ragged.coll_by_op_valid["all-gather"] == tb
    assert dense.exposed_collective_bytes() == 2 * tb
    assert ragged.exposed_collective_bytes() == 0.75 * tb + tb
    bk = ragged.overlap_by_kind()
    assert bk["collective-permute"]["total_bytes"] == tb
    assert bk["collective-permute"]["valid_bytes"] == 0.75 * tb
    with pytest.raises(ValueError):
        analyze(_stream(ops, colls()), valid_fractions={"nope": 0.5})
    with pytest.raises(ValueError):
        analyze(_stream(ops, colls()), valid_fractions={"all-gather": 0.0})


def test_walk_counts_storages_not_views_and_the_peak_above_entry():
    """The walk's def-use and memory follow storages: a view neither
    allocates nor breaks the chain, a freed storage leaves the live count,
    and what was live at entry does not count."""
    x = torch.zeros((256, 256))  # live at entry: 256 KiB, not counted
    with op_walk.OpWalk() as walk:
        y = x @ x  # 256 KiB
        v = y.t()  # a view: nothing
        z = v @ x  # another 256 KiB; peak 512 KiB
        del y, v
        w = z + 1  # z and w live: 512 KiB
        del z, w
        u = torch.empty(100)  # 400 B rounds to one 512-byte block
        del u
    st = walk.stats()
    assert st.peak_live_bytes == 2 * 256 * 256 * 4
    names = [op.name for op in walk.stream.ops]
    assert names == ["aten.mm", "aten.t", "aten.mm", "aten.add", "aten.empty"]
    mm2 = walk.stream.ops[2]
    assert mm2.reads == (walk.stream.ops[0].writes[0], walk.stream.ops[0].reads[0])
    assert st.flops == 2 * 2 * 256 ** 3


# ------------------------------------------------------------ roofline ----

def test_roofline_dominant_consistent_with_exposed_discount():
    """A cell whose collectives are all proven hideable is never
    ``dominant == "collective"``: ``dominant`` ranks the same discounted
    collective term ``roofline_fraction`` charges."""
    kw = dict(arch="a", shape="s", mesh="m", chips=8, hlo_flops=1e12, hlo_bytes=1e9,
              coll_bytes=1e12, coll_by_op={}, model_flops=1e12,
              t_compute=1e12 / rl.HW["peak_flops"], t_memory=1e9 / rl.HW["hbm_bw"],
              t_collective=1e12 / rl.HW["net_bw"])
    overlapped = rl.RooflineResult(**kw, coll_exposed_bytes=0.0, t_collective_exposed=0.0)
    assert overlapped.t_collective > overlapped.t_compute
    assert overlapped.dominant == "compute"
    serialized = rl.RooflineResult(**kw, coll_exposed_bytes=1e12,
                                   t_collective_exposed=1e12 / rl.HW["net_bw"])
    assert serialized.dominant == "collective"
    js = overlapped.to_json()
    assert js["t_collective_exposed"] == 0.0 and js["dominant"] == "compute"
    assert js["useful_ratio"] == 1e12 / (8 * 1e12)
    assert abs(js["roofline_fraction"] - (1e12 / 8 / rl.HW["peak_flops"])
               / overlapped.t_compute) < 1e-12
    assert "H100" in js["card"] and "700.00 W" in js["card"]


def test_roofline_links_and_peaks():
    """A collective is charged at the slowest link its group crosses (8
    GPUs a node, ranks row-major: a 16-wide model axis spans two nodes),
    and operations at their dtype's peak."""
    assert rl.link_rate(range(8)) == rl.HW["nvlink_bw"] == 450e9
    assert rl.link_rate(range(16)) == rl.HW["net_bw"] == 50e9
    assert rl.link_rate(range(0, 256, 16)) == 50e9  # a data-axis column
    assert work.peak_seconds(989e12, torch.bfloat16) == 1.0
    assert work.peak_seconds(67e12, torch.float32) == 1.0
    assert work.peak_seconds(495e12, "split_tf32") == 3.0
    assert work.causal_pairs(4096, 4096) == 4096 * 4097 // 2
    assert work.causal_pairs(4, 4, 4) == 16 and work.causal_pairs(4, 4, -4) == 0
