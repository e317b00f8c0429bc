"""The comm plans' overlap gates of the port's dry run
(``repro_torch.launch.dryrun``), on fake worlds in this process.

Each gate walks one rank's program of a comm plan with real small CPU
tensors (the fake backend moves no data: the programs' numerics are held on
gloo elsewhere) and holds the plan's declared intent against the walk's
verdict, with a negative control that must serialize.  The SUMMA, ragged
SUMMA and MoE gates are held against the reference's own walker at the same
sizes (``summa_dryrun``, ``ragged_summa_dryrun``, ``moe_dryrun`` in a JAX
subprocess); the sp ring, serving and ZeRO gates against the declared
intents, the port's comm models and their negative controls (the
reference's versions of those three fail on this jax's ``shard_map``).
"""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun
from repro_torch.models.sharding import ragged_seq_extents

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture
def world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference(distributed):
    """The reference's walker on its SUMMA, ragged SUMMA and MoE gates."""
    out = distributed("""
import json
from repro.launch.dryrun import moe_dryrun, ragged_summa_dryrun, summa_dryrun
rep = {"summa": summa_dryrun(ni=16, nj=16, nk=16, grid=(4, 2), majors="J/K/J", verbose=False),
       "ragged": ragged_summa_dryrun(verbose=False),
       "moe_balanced": moe_dryrun(routing="balanced", verbose=False),
       "moe_skewed": moe_dryrun(routing="skewed", verbose=False)}
print("JSON" + json.dumps(rep))
""")
    return json.loads(out.split("JSON", 1)[1])


def test_summa_gate_matches_reference_walker(world, reference):
    """(4, 2) at 16^3: R - 1 = 3 collective-permutes, 0 serialized of any
    kind, 0 exposed bytes, permute bytes equal to the ring model
    3 * 8 * 4 * 4, in both forms: the reference walker's counts, verdicts
    and bytes."""
    rep = dryrun.summa_dryrun(ni=16, nj=16, nk=16, grid=(4, 2), majors="J/K/J", verbose=False)
    for variant in ("double_buffered", "blocking"):
        got, ref = rep[variant], reference["summa"][variant]
        assert got["collective_permutes"] == 3 == ref["collective_permutes"]
        assert got["serialized"] == 0 == ref["serialized"]
        assert got["overlapped"] == ref["overlapped"] == 3
        assert got["collectives_serialized_any_kind"] == 0 == ref["collectives_serialized_any_kind"]
        assert got["collectives_overlapped_any_kind"] == ref["collectives_overlapped_any_kind"]
        assert got["exposed_bytes"] == 0.0 == ref["exposed_bytes"]
        assert got["op_permute_bytes"] == got["model_ring_bytes"] == 3 * 8 * 4 * 4
        assert got["op_permute_bytes"] == ref["hlo_permute_bytes"]
        assert got["permute_overlap_fraction"] == 1.0
        assert set(got["overlap_by_kind"]) == set(ref["overlap_by_kind"])
        assert got["plan"] == ref["plan"]


def test_ragged_summa_gate_matches_reference_walker(world, reference):
    """35^3 on (2, 4): nothing serialized, the wire bytes the padded ring
    model's and the valid bytes the ragged model's, as the reference's."""
    rep = dryrun.ragged_summa_dryrun(verbose=False)
    for variant in ("double_buffered", "blocking"):
        got, ref = rep[variant], reference["ragged"][variant]
        assert got["serialized"] == 0 == ref["serialized"]
        assert got["exposed_bytes"] == 0.0 == ref["exposed_bytes"]
        assert got["wire_matches_padded_model"] and got["valid_matches_ragged_model"]
        assert got["op_wire_permute_bytes"] == ref["hlo_wire_permute_bytes"]
        assert abs(got["op_valid_permute_bytes"] - ref["hlo_valid_permute_bytes"]) < 1e-6
        assert got["op_valid_permute_bytes"] < got["op_wire_permute_bytes"]
        kinds = got["overlap_by_kind"]
        assert kinds["collective-permute"]["overlapped"] == \
            ref["overlap_by_kind"]["collective-permute"]["overlapped"]
        assert got["plan"] == ref["plan"]


@pytest.mark.parametrize("routing", ["balanced", "skewed"])
def test_moe_gate_matches_reference_walker(world, reference, routing):
    """Two expert groups: both legs of every group overlapped (0 serialized
    all-to-alls, plan agreement), one dispatch and one combine per group;
    one group serializes (the negative control), as the reference's.  The
    port's all-to-alls move the counts table's rows, no padding: under
    balanced routing its bytes are the reference's valid bytes, under
    skewed routing below the reference's padded wire."""
    rep = dryrun.moe_dryrun(routing=routing, verbose=False)
    ref = reference[f"moe_{routing}"]
    ov, rov = rep["overlapped"], ref["overlapped"]
    assert ov["all_to_alls"] == 2 * ov["steps"] == rov["all_to_alls"]
    assert ov["serialized_a2a"] == 0 == rov["serialized_a2a"]
    assert ov["plan"] == rov["plan"] and ov["plan"]["agree"]
    assert ov["exposed_bytes"] == 0.0
    assert ov["wire_matches_model"]
    single, rsingle = rep["single"], ref["single"]
    assert single["serialized_a2a"] > 0 and rsingle["serialized_a2a"] > 0
    assert not single["plan"]["agree"] and not rsingle["plan"]["agree"]
    if routing == "balanced":
        assert ov["op_wire_a2a_bytes"] == rov["hlo_valid_a2a_bytes"] == ov["model_valid_bytes"]
    else:
        assert ov["op_wire_a2a_bytes"] < rov["hlo_wire_a2a_bytes"]


@pytest.mark.parametrize("seq,device", [(256, "cpu"), (250, "cpu"), (256, "cuda"),
                                        (250, "cuda")])
def test_sp_ring_gate(world, seq, device):
    """The sp ring attention of rank 0 on (2, 4): the double-buffered ring
    serializes nothing and agrees with the ring plan's declared intent; its
    2 (R - 1) K/V rotations move the capacity chunks (the valid fraction
    discounted when the sequence is ragged); the blocking ring, waiting each
    rotation of the projected K/V before the step that reads it, serializes
    every one (the negative control).  ``cuda`` walks the card's program:
    the carry kernel standing in for its R launches."""
    head_dim = 64 if device == "cuda" else 16
    rep = dryrun.sp_ring_dryrun(seq=seq, device=device, head_dim=head_dim, verbose=False)
    R, batch, n_kv = 4, 2, 2
    cap, _ = ragged_seq_extents(seq, R)
    item = 2 if device == "cuda" else 4
    wire = 2 * (R - 1) * (batch // 2) * n_kv * cap * head_dim * item
    db, blocking = rep["double_buffered"], rep["blocking"]
    assert db["collectives"] == db["expected_ring_transfers"] == 2 * (R - 1)
    assert db["serialized"] == 0 and db["exposed_bytes"] == 0.0
    assert db["plan"]["agree"] and db["plan"]["proven"] == "overlapped"
    assert db["boundary_serialized"] == 0
    assert db["op_wire_permute_bytes"] == wire
    assert abs(db["op_valid_permute_bytes"] - wire * seq / (R * cap)) < 1e-6
    assert blocking["serialized"] == 2 * (R - 1) and not blocking["plan"]["agree"]
    launches = {"flash_attention_carry_kernel": R} if device == "cuda" else {}
    assert db["kernel_launches"] == launches == blocking["kernel_launches"]


def test_serve_gate(world):
    """One TP decode step of phi4-mini's smoke config on (4, 2): staggered
    over 2 microbatches nothing serializes (each microbatch's reduction
    waited where the next stage reads it), in agreement with the declared
    ``stagger`` intent; one microbatch serializes (the negative control)."""
    rep = dryrun.serve_dryrun(verbose=False)
    stag, single = rep["staggered"], rep["single"]
    assert stag["serialized"] == 0 and stag["exposed_bytes"] == 0.0
    assert stag["plan"]["agree"] and stag["plan"]["proven"] == "overlapped"
    bk = stag["overlap_by_kind"]
    # 2 microbatches x (embedding + 2 stages a layer) reductions, 2 logit gathers
    assert bk["all-reduce"]["overlapped"] == 2 * (1 + 2 * 2)
    assert bk["all-gather"]["overlapped"] == 2
    assert single["serialized"] > 0 and not single["plan"]["agree"]


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_train_gate(world, compress):
    """The ZeRO-2 step of phi4-mini's smoke config on 8 data ranks: with its
    64 KiB buckets no reduce-scatter or all-gather serializes (the
    kind-scoped ``bucket`` plan agrees), the wire and valid bytes are
    ``zero_comm_model``'s in both forms, and one bucket holding the whole
    model serializes its reduce-scatter (the negative control)."""
    rep = dryrun.train_dryrun(compress=compress, verbose=False)
    bk = rep["bucketed"]
    assert bk["n_buckets"] >= 3
    assert bk["serialized_rs"] == 0 and bk["serialized_ag"] == 0
    assert bk["plan_rs"]["agree"] and bk["plan_ag"]["agree"]
    for variant in ("bucketed", "blocking"):
        assert rep[variant]["wire_matches_model"] and rep[variant]["valid_matches_model"]
        assert rep[variant]["overlap_by_kind"]["reduce-scatter"]["overlapped"] + \
            rep[variant]["overlap_by_kind"]["reduce-scatter"]["serialized"] == bk["n_buckets"]
    assert rep["single_bucket"]["n_buckets"] == 1
    assert rep["single_bucket"]["serialized_rs"] > 0


def test_plan_report(world, tmp_path):
    """Fifteen plans, every declared intent proven, every negative control
    serialized; the table is written as JSON and the exit code is 0."""
    path = tmp_path / "plan.json"
    assert dryrun.plan_report(str(path), verbose=False) == 0
    report = json.loads(path.read_text())
    assert report["n_plans"] == 15 == len(report["plans"])
    assert report["agree_all"] and report["n_disagreements"] == 0
    for row in report["plans"]:
        assert row["agree"] and row["declared"] == "overlapped" == row["proven"]
        assert row.get("negative_control_serialized", 1) > 0, row
    programs = {r["program"] for r in report["plans"]}
    assert {"summa_ring", "ragged_summa_ring", "sp_ring_attention", "serve_tp_decode",
            "moe_ep_dispatch_skewed", "zero_train_int8_all_gather"} <= programs


def test_cli_gate_exit_codes(tmp_path):
    """The command line's gates exit 0 when they hold; a cell's record
    goes under ``--out`` and never under ``benchmarks/``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    run = [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun"]
    proc = subprocess.run(run + ["--summa-gemm", "--summa-dims", "16,16,16", "--summa-grid",
                                 "4x2"], capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    proc = subprocess.run(run + ["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
                                 "--out", "benchmarks/x"], capture_output=True, text=True,
                          env=env, timeout=240, cwd=tmp_path)
    assert proc.returncode != 0 and not (tmp_path / "benchmarks").exists()
