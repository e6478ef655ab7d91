"""The port's public namespaces against the JAX package's.

Every ``__all__`` of the JAX package's root, ``utils``, ``ops``, ``io``,
``testing``, ``parallel`` and ``fleet`` is a subset of the port module's,
less the names left out for good (no ``shard_map`` and no named axes in the
port; the ingest router records its retire event itself). The compile
cache's names live where the JAX package defines them: ``ops.compile_cache``
and ``testing.faults``.
"""
from __future__ import annotations

import importlib

import pytest

MODULES = ("", ".utils", ".ops", ".io", ".testing", ".parallel", ".fleet")

#: left out for good (ROADMAP Queue C)
LEFT_OUT = {"shard_map_compat", "in_named_axis_context", "notify_dispatched"}


@pytest.mark.parametrize("module", MODULES, ids=[m or "root" for m in MODULES])
def test_jax_names_are_exported_by_the_port(module):
    ref = importlib.import_module(f"torchmetrics_tpu{module}")
    port = importlib.import_module(f"torchmetrics_tpu_torch{module}")
    missing = set(ref.__all__) - set(port.__all__) - LEFT_OUT
    assert not missing
    assert all(hasattr(port, name) for name in port.__all__)


@pytest.mark.parametrize("module", MODULES, ids=[m or "root" for m in MODULES])
def test_the_named_list_is_still_missing(module):
    """A name of the list that the port exports must leave the list."""
    port = importlib.import_module(f"torchmetrics_tpu_torch{module}")
    assert not (set(port.__all__) & LEFT_OUT)


@pytest.mark.parametrize(
    "module,names",
    [
        ("utils", ("check_forward_full_state_property", "class_reduce", "reduce", "rank_zero_debug", "rank_zero_info",
                   "to_onehot", "to_categorical", "allclose", "DataType", "MDMCAverageMethod")),
        ("ops", ("gate_snapshot", "resolve_backend")),
        ("testing", ("hang_sync", "break_sync", "fail_dispatch")),
        ("", ("TorchMetricsUserError", "TorchMetricsUserWarning", "SyncTimeoutError", "StateCorruptionError",
              "StateDivergenceError", "CheckpointCorruptionError", "TopologyMismatchError", "ShardLossError",
              "LaneFaultError", "DispatchStallError", "Autosaver", "save_state", "restore_state",
              "install_preemption_handler", "MetricFuture", "pending_reads", "drain_async_reads",
              "dump_diagnostics", "telemetry_snapshot", "obs", "executor_stats")),
    ],
)
def test_names_added_with_the_executor_are_the_jax_names(module, names):
    suffix = "." + module if module else ""
    port = importlib.import_module(f"torchmetrics_tpu_torch{suffix}")
    homes = [importlib.import_module(f"torchmetrics_tpu{suffix}")]
    if module == "utils":  # some live in JAX's submodules only
        homes += [importlib.import_module(f"torchmetrics_tpu.utils.{sub}") for sub in ("checks", "data", "enums", "prints")]
    for name in names:
        assert name in port.__all__ and hasattr(port, name), name
        assert any(hasattr(home, name) for home in homes), name


def test_small_utils_match_jax():
    import jax.numpy as jnp
    import numpy as np
    import torch

    import torchmetrics_tpu.utils.data as jax_data
    import torchmetrics_tpu_torch.utils as port_utils
    from torchmetrics_tpu.utils import enums as jax_enums

    labels = np.array([[0, 2], [1, 1]], dtype=np.int32)
    np.testing.assert_array_equal(
        port_utils.to_onehot(torch.from_numpy(labels), num_classes=3).numpy(),
        np.asarray(jax_data.to_onehot(jnp.asarray(labels), num_classes=3)),
    )
    probs = np.random.RandomState(0).rand(4, 5).astype(np.float32)
    np.testing.assert_array_equal(
        port_utils.to_categorical(torch.from_numpy(probs)).numpy(), np.asarray(jax_data.to_categorical(jnp.asarray(probs)))
    )
    assert port_utils.allclose(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.0 + 1e-9]))
    assert not port_utils.allclose(torch.tensor([1.0]), torch.tensor([1.1]))
    assert [m.value for m in port_utils.DataType] == [m.value for m in jax_enums.DataType]
    assert [m.value for m in port_utils.MDMCAverageMethod] == [m.value for m in jax_enums.MDMCAverageMethod]
    from torchmetrics_tpu_torch.ops import resolve_backend

    assert resolve_backend("cpu") == "reference" and resolve_backend("cuda") == "cuda"


@pytest.mark.parametrize(
    "module,names,home",
    [
        ("", ("make_synced_collection_step",), "torchmetrics_tpu"),
        ("ops", ("make_synced_collection_step", "DeferredCollectionStep", "make_deferred_collection_step",
                 "latest_recovery_snapshot", "make_value_packer"), "torchmetrics_tpu.ops.executor"),
        ("fleet", ("deferred_source",), "torchmetrics_tpu.fleet"),
        ("testing", ("drop_shard",), "torchmetrics_tpu.testing.faults"),
    ],
)
def test_deferred_step_and_recovery_names_are_exported(module, names, home):
    """The deferred collection step's and the recovery snapshot's names:
    exported by the port's root, ``ops``, ``fleet`` and ``testing``, each
    defined in the JAX package where it defines the name."""
    suffix = "." + module if module else ""
    port = importlib.import_module(f"torchmetrics_tpu_torch{suffix}")
    ref = importlib.import_module(home)
    for name in names:
        assert name in port.__all__ and hasattr(port, name), name
        assert hasattr(ref, name), name


@pytest.mark.parametrize(
    "module,names",
    [
        ("ops.compile_cache", ("CompileWorker", "get_worker", "drain_worker", "save_shape_manifest", "load_shape_manifest",
                               "spec_of_call", "dummy_from_spec", "prune_store", "CacheEntryInvalid", "source_hash",
                               "toolchain_fingerprint", "backend_fingerprint", "entry_key", "entry_path",
                               "compile_ahead_enabled", "background_compile_default", "cache_dir", "cache_max_bytes")),
        ("testing.faults", ("corrupt_cache_entry", "stale_cache_version", "torn_write")),
    ],
)
def test_compile_cache_names_are_where_jax_defines_them(module, names):
    """The compile cache's names, defined by the port's module of the JAX
    package's name (``ops.compile_cache``, ``testing.faults``); the spec
    helpers stay importable from ``ops.executor`` too."""
    port = importlib.import_module(f"torchmetrics_tpu_torch.{module}")
    ref = importlib.import_module(f"torchmetrics_tpu.{module}")
    for name in names:
        assert hasattr(port, name) and hasattr(ref, name), name
    testing = importlib.import_module("torchmetrics_tpu_torch.testing")
    assert {"corrupt_cache_entry", "stale_cache_version"} <= set(testing.__all__)
    from torchmetrics_tpu_torch.ops import executor

    assert executor.spec_of_call is importlib.import_module("torchmetrics_tpu_torch.ops.compile_cache").spec_of_call
