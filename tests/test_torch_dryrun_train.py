"""The port's dry run of a train step (forward, backward and the Adam
update with ZeRO-1 moments) on a fake 4x2 mesh: a reduced MoE combo over
two microbatches reaches ``ok`` with the JAX package's record keys; and
``main`` over several combos, each in a process of its own.  Apart from
``test_torch_dryrun.py`` so that xdist spreads the two files."""
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models.config import InputShape
from test_torch_dryrun import MESH_4X2, check_record


def test_train_combo_reaches_ok_on_a_fake_4x2_mesh():
    # a shape of its own name: train_4k's combo override would cut 8 rows
    # into 16 microbatches
    arch, microbatches = "granite-moe-3b-a800m", 2
    cfg = configs.reduced(configs.get_arch(arch))
    shape = InputShape("train_small", 64, 8, "train")
    rec = dryrun.run_combo(arch, shape.name, MESH_4X2, cfg=cfg, shape=shape,
                           microbatches=microbatches)
    assert rec["status"] == "ok", rec.get("error")
    check_record(rec, cfg, shape)
    assert rec["objective"] == "bc"
    # the update's gradient sums and the ZeRO-1 moments take collectives
    assert rec["hlo"]["collective_bytes"] > 0


def test_main_runs_each_combo_in_a_process_of_its_own(tmp_path):
    """Several combos: ``main`` runs each in a child process, side by side,
    and each appends its record; a skipped combo is recorded, not dropped,
    on both meshes."""
    import json

    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                        "--mesh", "both", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert sorted(r["mesh"] for r in recs) == ["multi", "single"]
    assert all(r["status"] == "skipped" and r["reason"] for r in recs)
