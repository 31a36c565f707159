"""repro_torch.experiments and what it stands on, against the JAX package:
``run_experiment`` with DQN on Catch (the ci smoke's learning acceptance,
DQNConfig() defaults, the vectorized branch, the loop's bookkeeping
against the reference's on the same config), bit-exact resume from a
``RunCheckpointer`` snapshot, checkpoints that cross between the two
packages, ``ExperimentConfig``'s checks, and the loggers and
``MetricsHub`` run through the reference's own cases.

The port runs on the CPU here (``device="cpu"``).  Whole runs cannot match
the reference's traces (its actors draw from threefry), so a run is held to
the reference's acceptance and to the parts of its result that do not
depend on the draws: Catch episodes all last 9 steps, so the actor-step
curve, the eval points, the counters and the learner's schedule are equal.
"""
import csv
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.agents import dqn
from repro_torch.checkpoint import Checkpointer, CheckpointError
from repro_torch.core import make_environment_spec
from repro_torch.envs import Catch
from repro_torch.experiments import (ExperimentConfig, run_distributed_experiment,
                                     run_experiment, run_offline_experiment)
from repro_torch.resilience import RunCheckpointer
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
PACKAGES = ["repro", "repro_torch"]
# conftest.DQNCatchBuilderFactory's smoke preset
SMOKE = dict(min_replay_size=50, samples_per_insert=4.0, batch_size=16,
             n_step=1, epsilon=0.2)


class _Builder:
    def __init__(self, seed, knobs):
        self.seed, self.knobs = seed, knobs

    def __call__(self, spec):
        return dqn.DQNBuilder(spec, dqn.DQNConfig(**self.knobs),
                              seed=self.seed, device=CPU)


def _config(*, seed=0, builder_seed=None, **knobs):
    """The port's twin of conftest.make_dqn_catch_config: DQNConfig field
    names go to the builder, everything else to the config."""
    fields = {f.name for f in dataclasses.fields(dqn.DQNConfig)}
    builder_knobs = dict(SMOKE, **{k: v for k, v in knobs.items()
                                   if k in fields})
    return ExperimentConfig(
        builder_factory=_Builder(seed if builder_seed is None
                                 else builder_seed, builder_knobs),
        environment_factory=lambda s: Catch(seed=s), seed=seed,
        **{k: v for k, v in knobs.items() if k not in fields})


def _spec():
    return make_environment_spec(Catch(seed=0))


def _assert_states_equal(a, b):
    leaves_a, leaves_b = tree.leaves(a), tree.leaves(b)
    assert len(leaves_a) == len(leaves_b) > 0
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y)


# ----------------------------------------------------------------- learning
def test_ci_smoke_learns_catch():
    """scripts/ci.sh's DQN-on-Catch smoke through the port: 150 episodes,
    seed 0; the final eval beats the mean of the first 20 train returns."""
    config = ExperimentConfig(
        builder_factory=lambda spec: dqn.DQNBuilder(
            spec, dqn.DQNConfig(min_replay_size=50, samples_per_insert=0.0,
                                batch_size=32, n_step=1, epsilon=0.2),
            seed=0, device=CPU),
        environment_factory=lambda seed: Catch(seed=seed),
        seed=0, num_episodes=150, eval_episodes=20)
    result = run_experiment(config)
    assert result.learner_steps > 0
    final = result.final_eval_return
    assert final is not None and final > np.mean(result.train_returns[:20])
    params = result.learner.state.params
    assert all(t.device.type == "cpu" for t in tree.leaves(params))


def test_dqn_config_defaults_run_through_the_rate_limiter():
    """DQNConfig() as it is (n-step 3, samples per insert 4, a
    SampleToInsertRatio limiter, batch 64, 200 transitions before the first
    step): the learner steps on the limiter's schedule."""
    config = ExperimentConfig(
        builder_factory=lambda spec: dqn.DQNBuilder(spec, dqn.DQNConfig(),
                                                    device=CPU),
        environment_factory=lambda seed: Catch(seed=seed),
        seed=0, num_episodes=60, eval_episodes=2)
    result = run_experiment(config)
    # 60 x 9 = 540 transitions, one learner step per 16 after the first 200
    assert result.learner_steps == (540 - 200) // 16 + 1
    assert result.actor_steps[-1] == 540
    assert np.isfinite(result.learner.metrics["loss"])
    assert all(bool(torch.isfinite(t).all())
               for t in tree.leaves(result.learner.state.params))


@pytest.mark.parametrize("num_envs", [1, 4])
def test_run_bookkeeping_matches_reference(num_envs):
    """The same config through both packages: the actor-step curve, the
    eval points, the counters and the learner steps are equal (none of them
    depends on the exploration draws); the port's returns are Catch's."""
    from conftest import make_dqn_catch_config
    from repro.experiments import run_experiment as jax_run_experiment
    knobs = dict(seed=1, num_episodes=24, eval_every=8, eval_episodes=3,
                 min_replay_size=20, num_envs_per_actor=num_envs)
    port = run_experiment(_config(**knobs))
    ref = jax_run_experiment(make_dqn_catch_config(**knobs))
    assert port.actor_steps == ref.actor_steps
    assert [p for p, _ in port.eval_returns] == \
        [p for p, _ in ref.eval_returns]
    assert port.counts == ref.counts
    assert port.learner_steps == ref.learner_steps > 0
    assert len(port.train_returns) == len(ref.train_returns) >= 24
    assert set(port.train_returns) <= {-1.0, 1.0}
    assert len(port.walltime) == len(port.train_returns)


def test_logger_factory_and_telemetry(tmp_path):
    """The train loop logs each episode through the config's logger; with
    telemetry on, the merged snapshot carries one learner/step_ms sample
    per learner step, and the hub's JSONL gets the final push."""
    from repro_torch.core.loggers import InMemoryLogger
    from repro_torch.telemetry import registry
    loggers = {}

    def factory(label):
        loggers[label] = InMemoryLogger()
        return loggers[label]

    path = tmp_path / "telemetry.jsonl"
    try:
        result = run_experiment(_config(
            num_episodes=10, eval_episodes=0, min_replay_size=20,
            logger_factory=factory, telemetry=True,
            telemetry_jsonl=str(path)))
    finally:
        registry.unconfigure()
    assert list(loggers) == ["train"]
    rows = loggers["train"].rows
    assert len(rows) == 10 and rows[-1]["episode_return"] in (-1.0, 1.0)
    merged = result.extras["telemetry"]["merged"]
    assert merged["learner/step_ms"]["count"] == result.learner_steps > 0
    (record,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert record["node"] == "local"


def test_unported_entry_points_raise():
    """Every entry point and knob is ported: run_distributed_experiment runs
    (here on threads, on the CPU), with async learner sync and shard-affine
    routing too, and run_offline_experiment refuses an online builder, as
    the reference's do."""
    config = _config(num_episodes=1, eval_episodes=0)
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=200, timeout_s=60)
    assert result.counts["actor_steps"] >= 200
    assert result.extras["launcher"] == "local"
    with pytest.raises(ValueError, match="offline"):
        run_offline_experiment(config, num_learner_steps=1)
    knobbed = run_distributed_experiment(
        _config(eval_episodes=0, learner_sync="async",
                num_learner_replicas=2, learner_average_period=5,
                replay_routing="affinity", num_envs_per_actor=2),
        num_actors=1, max_actor_steps=200, timeout_s=60)
    assert knobbed.counts["actor_steps"] >= 200
    assert knobbed.extras["learners"]["sync"] == "async"
    assert all(s["inserts"] > 0 for s in knobbed.extras["replay"]["per_shard"])


# ------------------------------------------------------------------- resume
def test_resume_is_bit_exact(tmp_path):
    """The reference's parity pin: 4 episodes and a final snapshot, resumed
    to 8, are bit-identical (params, optimizer state, counters, the train
    curve) to 8 episodes uninterrupted."""
    straight = run_experiment(_config(seed=3, min_replay_size=10,
                                      num_episodes=8, eval_episodes=0))
    cfg = _config(seed=3, min_replay_size=10, num_episodes=4,
                  eval_episodes=0, checkpoint_dir=str(tmp_path))
    run_experiment(cfg)
    resumed = run_experiment(dataclasses.replace(cfg, num_episodes=8,
                                                 resume=True))
    assert resumed.learner_steps == straight.learner_steps > 0
    assert resumed.train_returns == straight.train_returns
    assert resumed.actor_steps == straight.actor_steps
    assert resumed.counts == straight.counts
    _assert_states_equal(resumed.learner.state, straight.learner.state)


class _Crash(Exception):
    pass


def test_resume_after_a_crash_mid_run_is_bit_exact(tmp_path):
    """A run that dies mid-training (no cleanup, no final save) resumes
    from its last cadence snapshot to the uninterrupted run's state; the
    actors' RNG streams resume from their step counters and the replay
    selector from its saved random state."""
    def crash_after(n):
        def factory(label):
            def log(result):
                nonlocal n
                n -= 1
                if n <= 0:
                    raise _Crash()
            return log
        return factory

    knobs = dict(seed=7, min_replay_size=10, num_episodes=10,
                 eval_episodes=0)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(_Crash):
        run_experiment(_config(**knobs, checkpoint_dir=ckpt,
                               checkpoint_every=1,
                               logger_factory=crash_after(6)))
    assert (tmp_path / "ckpt" / "run_latest.json").exists()
    resumed = run_experiment(_config(**knobs, checkpoint_dir=ckpt,
                                     checkpoint_every=1, resume=True))
    straight = run_experiment(_config(**knobs))
    assert resumed.learner_steps == straight.learner_steps
    assert resumed.train_returns == straight.train_returns
    assert resumed.counts == straight.counts
    _assert_states_equal(resumed.learner.state, straight.learner.state)


def test_snapshot_carries_every_rng_stream(tmp_path):
    """What exact resume rests on: the actor's step counter (its whole
    RNG state), the Prioritized selector's random state and the env's."""
    run_experiment(_config(seed=2, min_replay_size=10, num_episodes=3,
                           eval_episodes=0, checkpoint_dir=str(tmp_path)))
    template = dqn.make_learner(
        _spec(), dqn.DQNConfig(**SMOKE), iter(()),
        torch.Generator().manual_seed(0), device=CPU).state
    snapshot = RunCheckpointer(str(tmp_path)).restore(template)
    actor = snapshot.run_state["agent"]["actor"]
    assert actor["steps"] == 27
    assert snapshot.replay["selector"]["kind"] == "Prioritized"
    assert snapshot.replay["selector"]["rng"][0] == 3      # random.Random
    assert "env" in snapshot.run_state
    assert snapshot.counts["actor_steps"] == 27


# ------------------------------------------------ checkpoints across packages
def _learner_states(seed=0):
    """The reference's and the port's DQN learner states, equal leaf for
    leaf: the port's copied from the reference's through numpy."""
    import jax
    from repro.agents import dqn as jax_dqn
    from repro.core import make_environment_spec as jax_spec
    from repro.envs import Catch as JaxCatch
    cfg = dqn.DQNConfig()
    ref = jax_dqn.make_learner(jax_spec(JaxCatch()), cfg, iter(()),
                               jax.random.key(seed)).state
    port = dqn.make_learner(_spec(), cfg, iter(()),
                            torch.Generator().manual_seed(seed),
                            device=CPU).state
    return ref, port


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    import jax
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    ref, template = _learner_states(seed=1)
    JaxCheckpointer(str(tmp_path)).save(ref, 7, metadata={"run": "jax"})
    state, meta = Checkpointer(str(tmp_path)).restore(template)
    assert meta == {"run": "jax", "step": 7}
    assert type(state) is type(template)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    for got, want, like in zip(tree.leaves(state), ref_leaves,
                               tree.leaves(template)):
        assert isinstance(got, torch.Tensor) and got.device == like.device
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    import jax
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    ref, port = _learner_states(seed=2)
    Checkpointer(str(tmp_path)).save(port, 3)
    state, meta = JaxCheckpointer(str(tmp_path)).restore(ref)
    assert meta == {"step": 3}
    for got, want in zip(jax.tree_util.tree_leaves(state),
                         tree.leaves(port)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_checkpoint_rejects_a_template_of_another_structure(tmp_path):
    _, port = _learner_states()
    Checkpointer(str(tmp_path)).save(port, 1)
    with pytest.raises(CheckpointError, match="leaves"):
        Checkpointer(str(tmp_path)).restore(port.params)
    wrong = port._replace(steps=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(CheckpointError, match="shape"):
        Checkpointer(str(tmp_path)).restore(wrong)


@pytest.mark.parametrize("package", PACKAGES)
def test_run_checkpointer_protocol(package, tmp_path):
    """Both packages' RunCheckpointer: the manifest names the newest step,
    gc keeps ``keep`` steps, a missing file or a corrupt manifest raises
    CheckpointError, and an empty directory restores nothing."""
    module = importlib.import_module(f"{package}.resilience.run_checkpoint")
    error = importlib.import_module(f"{package}.checkpoint").CheckpointError
    ckpt = module.RunCheckpointer(str(tmp_path), keep=2)
    template = {"w": np.zeros(3, np.float32), "n": np.zeros((), np.int32)}
    assert ckpt.restore(template) is None
    for step in (1, 2, 3):
        ckpt.save(step, {"w": np.full(3, step, np.float32),
                         "n": np.array(step, np.int32)},
                  replay={"items": [step]}, counts={"actor_steps": step},
                  run_state={"rng": step}, meta={"mode": "test"})
    assert ckpt.list_steps() == [2, 3] and ckpt.latest_step() == 3
    snapshot = ckpt.restore(template)
    assert snapshot.step == 3 and snapshot.replay == {"items": [3]}
    assert snapshot.counts == {"actor_steps": 3}
    assert snapshot.run_state == {"rng": 3}
    assert snapshot.meta == {"mode": "test"}
    np.testing.assert_array_equal(snapshot.learner_state["w"], [3, 3, 3])
    (tmp_path / "replay_3.pkl").unlink()
    with pytest.raises(error, match="missing"):
        ckpt.restore(template)
    (tmp_path / "run_latest.json").write_text("{not json")
    with pytest.raises(error, match="corrupt"):
        ckpt.restore(template)


def test_checkpoint_restores_tensors_to_the_templates_device(tmp_path):
    state = {"a": torch.arange(4.0), "b": [torch.ones(2, 2)],
             "c": np.arange(3)}
    Checkpointer(str(tmp_path)).save(state, 5)
    restored, _ = Checkpointer(str(tmp_path)).restore(state)
    assert torch.equal(restored["a"], state["a"])
    assert restored["a"].device == state["a"].device
    assert torch.equal(restored["b"][0], state["b"][0])
    assert isinstance(restored["c"], np.ndarray)


# ------------------------------------------------------------------- config
BAD_CONFIGS = [dict(num_episodes=0), dict(eval_every=-1),
               dict(eval_episodes=-1), dict(checkpoint_every=-1),
               dict(num_replay_shards=0), dict(prefetch_size=-1),
               dict(launcher=""), dict(num_envs_per_actor=0),
               dict(inference="remote"), dict(inference_max_batch_size=0),
               dict(inference_max_wait_ms=-1.0),
               dict(num_learner_replicas=0), dict(learner_average_period=0),
               dict(telemetry_push_period_s=0.0), dict(resume=True),
               dict(barrier_timeout_s=0.0), dict(min_quorum=2),
               dict(barrier_timeout_s=1.0, min_quorum=0),
               dict(learner_sync="gossip"), dict(learner_sync="quorum"),
               dict(learner_sync="async", barrier_timeout_s=1.0),
               dict(replay_routing="random"),
               dict(service_snapshot_period_s=0.0)]


@pytest.mark.parametrize("knobs", BAD_CONFIGS,
                         ids=lambda k: ",".join(f"{a}={b}"
                                                for a, b in k.items()))
def test_config_checks_match_reference(knobs):
    from conftest import make_dqn_catch_config
    with pytest.raises(ValueError):
        make_dqn_catch_config(**knobs)
    with pytest.raises(ValueError):
        _config(**knobs)


@pytest.mark.parametrize("field", ["restart_policy", "chaos", "rpc_retry"])
def test_distributed_only_fields_raise_until_ported(field):
    """The distributed-only fields are ported: each takes its own type
    only, and raises ValueError naming it otherwise, as the reference's
    do."""
    from repro_torch.distributed import RetryConfig
    from repro_torch.resilience import ChaosPolicy, RestartPolicy
    good, name = {"restart_policy": (RestartPolicy(), "RestartPolicy"),
                  "chaos": (ChaosPolicy(), "ChaosPolicy"),
                  "rpc_retry": (RetryConfig(), "RetryConfig")}[field]
    with pytest.raises(ValueError, match=name):
        _config(**{field: object()})
    assert getattr(_config(**{field: good}), field) == good


def test_result_reports_the_final_eval():
    result = run_experiment(_config(num_episodes=2, eval_episodes=0))
    assert result.final_eval_return is None and result.eval_returns == []
    assert result.learner_steps == 0 and result.train_returns


# ------------------------------------------------------ loggers and the hub
@pytest.mark.parametrize("package", PACKAGES)
def test_csv_logger_roundtrip(package, tmp_path):
    loggers = importlib.import_module(f"{package}.core.loggers")
    path = str(tmp_path / "log.csv")
    lg = loggers.CSVLogger(path)
    lg({"step": 1, "return": 0.5})
    lg({"step": 2, "return": 0.7, "extra_ignored": 1})
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and rows[1]["step"] == "2"
    # an existing empty file is treated as new: the header is written
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    loggers.CSVLogger(str(empty))({"a": 1})
    assert empty.read_text().splitlines() == ["a", "1"]


@pytest.mark.parametrize("package", PACKAGES)
def test_in_memory_dispatch_and_terminal_format(package, capsys):
    loggers = importlib.import_module(f"{package}.core.loggers")
    mem = loggers.InMemoryLogger()
    disp = loggers.Dispatcher(mem, loggers.TerminalLogger("test"))
    disp({"a": 1.0, "b": np.float32(0.123), "n": 3})
    assert mem.rows == [{"a": 1.0, "b": np.float32(0.123), "n": 3}]
    assert capsys.readouterr().out == "[test] a=1.000, b=0.123, n=3\n"
    quiet = loggers.TerminalLogger("q", every_s=3600.0)
    quiet({"x": 1})
    quiet({"x": 2})
    assert capsys.readouterr().out == "[q] x=1\n"


def _snapshot_with(telemetry, events):
    reg = telemetry.MetricRegistry(enabled=True)
    reg.counter("events").inc(events)
    reg.histogram("lat_ms").observe(float(events))
    return reg.snapshot()


@pytest.mark.parametrize("package", PACKAGES)
def test_hub_aggregates_and_keeps_latest_per_node(package):
    telemetry = importlib.import_module(f"{package}.telemetry")
    hub = telemetry.MetricsHub()
    hub.push("actor/0", _snapshot_with(telemetry, 5))
    hub.push("actor/1", _snapshot_with(telemetry, 7))
    hub.push("actor/0", _snapshot_with(telemetry, 10))
    snap = hub.snapshot()
    assert sorted(snap["nodes"]) == ["actor/0", "actor/1"]
    assert snap["num_nodes"] == 2 and snap["num_pushes"] == 3
    assert snap["merged"]["events"]["value"] == 17
    assert snap["merged"]["lat_ms"]["count"] == 2
    assert hub.nodes() == ["actor/0", "actor/1"] and hub.num_pushes() == 3
    report = hub.report()
    assert "2 node(s)" in report and "events" in report
    assert telemetry.format_report(snap) == report


@pytest.mark.parametrize("package", PACKAGES)
def test_hub_jsonl_export(package, tmp_path):
    telemetry = importlib.import_module(f"{package}.telemetry")
    path = tmp_path / "telemetry.jsonl"
    hub = telemetry.MetricsHub(jsonl_path=str(path))
    hub.push("a", _snapshot_with(telemetry, 1))
    hub.push("b", _snapshot_with(telemetry, 2))
    hub.stop()
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["node"] for r in records] == ["a", "b"]
    for r in records:
        assert r["metrics"]["events"]["type"] == "counter"
        assert "reservoir" not in r["metrics"]["lat_ms"]
    hub.stop()
    assert hub.snapshot()["num_nodes"] == 2
