"""The control plane of both packages: the reference's scenarios of
``test_state_store.py``, ``test_endpoints.py``, ``test_request_processor.py``
and ``test_cli.py``, each run against ``clearml_serving_tpu`` (the
reference) and ``clearml_serving_tpu_torch`` (the port), so each case
counts once per package; and one state root written by either package's CLI,
read the same by both packages' processors and served by each."""

import asyncio
import importlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

PACKAGES = ["clearml_serving_tpu", "clearml_serving_tpu_torch"]
IDS = ["reference", "port"]

ECHO_CODE = """
class Preprocess:
    def process(self, data, state, collect_fn):
        return {"echo": data}
"""

DOUBLE_CODE = """
class Preprocess:
    def process(self, data, state, collect_fn):
        return {"y": [v * 2 for v in data["x"]]}
"""


def _package(name):
    return SimpleNamespace(
        name=name,
        state=importlib.import_module(name + ".state"),
        ep=importlib.import_module(name + ".serving.endpoints"),
        mrp=importlib.import_module(name + ".serving.model_request_processor"),
        cli=importlib.import_module(name + ".__main__").cli,
    )


def _processor(pk, **kwargs):
    if pk.name.endswith("_torch"):
        # the port's engines run where the caller says: the CPU here
        kwargs.setdefault("device", "cpu")
    return pk.mrp.ModelRequestProcessor(**kwargs)


@pytest.fixture(autouse=True)
def own_cache_dir(tmp_path, monkeypatch):
    """Each test copies user code into an artifact cache of its own: test
    files that run at once must not rename into one shared cache."""
    monkeypatch.setenv("TPUSERVE_CACHE_DIR", str(tmp_path / "cache"))


@pytest.fixture(params=PACKAGES, ids=IDS)
def pk(request):
    return _package(request.param)


# -- state store (test_state_store.py) -------------------------------------


def test_service_lifecycle(pk, state_root):
    store = pk.state.StateStore(state_root)
    svc = store.create_service("my-serving", project="DevOps")
    assert svc.exists
    assert store.get_service(svc.id).name == "my-serving"

    svc.update_parameters({"serving_base_url": "http://127.0.0.1:8080/serve"})
    assert svc.get_parameters()["serving_base_url"].endswith("/serve")

    svc.set_configuration_objects({"endpoints": {"a": {"x": 1}}})
    assert svc.get_configuration_object("endpoints") == {"a": {"x": 1}}
    assert svc.get_configuration_object("missing") is None

    c0 = svc.update_counter
    svc.set_runtime_properties({"version": "9.9"})
    assert svc.update_counter == c0 + 1

    svc.ping(instance_id="inst-1")
    listed = store.list_services()
    assert len(listed) == 1 and listed[0]["id"] == svc.id
    assert store.find_service("my-serving").id == svc.id
    assert store.find_service("unknown") is None


def test_artifacts(pk, state_root, tmp_path):
    store = pk.state.StateStore(state_root)
    svc = store.create_service("svc")
    code = tmp_path / "preprocess.py"
    code.write_text("def preprocess(x):\n    return x\n")
    svc.upload_artifact("py_code_ep1", code)
    stored = svc.get_artifact("py_code_ep1")
    assert stored and stored.is_file()
    assert "def preprocess" in stored.read_text()
    assert svc.artifact_hash("py_code_ep1")
    assert svc.list_artifacts() == ["py_code_ep1"]

    # package dir becomes a zip
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text("x = 1\n")
    svc.upload_artifact("py_code_pkg", pkg)
    assert svc.get_artifact("py_code_pkg").suffix == ".zip"


def test_model_registry(pk, state_root, tmp_path):
    reg = pk.state.ModelRegistry(state_root)
    f = tmp_path / "model.pkl"
    f.write_bytes(b"weights")
    m1 = reg.register("iris-clf", project="examples", path=f, framework="sklearn")
    m2 = reg.register("iris-clf", project="examples", path=f, publish=True)
    reg.register("other", project="elsewhere", path=f)

    got = reg.get(m1.id)
    assert got and got.name == "iris-clf"
    assert Path(got.get_local_copy()).read_bytes() == b"weights"

    res = reg.query(project="examples", name="iris-clf")
    assert [m.id for m in res] == [m2.id, m1.id]  # newest first
    assert [m.id for m in reg.query(project="examples", only_published=True)] == [m2.id]
    assert len(reg.query(max_results=2)) == 2

    m1.publish()
    assert reg.get(m1.id).published

    # tag query
    m2.set_metadata(tags=["prod"])
    assert [m.id for m in reg.query(tags=["prod"])] == [m2.id]


# -- endpoint records (test_endpoints.py) ----------------------------------


def test_model_endpoint_roundtrip(pk):
    ep = pk.ep.ModelEndpoint(
        engine_type="sklearn",
        serving_url="test_model_sklearn",
        model_id="abc",
        input_size=[1, 4],
        input_type="float32",
        input_name="features",
        output_size=[1],
        output_type="float32",
    )
    d = ep.as_dict()
    ep2 = pk.ep.ModelEndpoint.from_dict(d)
    assert ep2 == ep
    # scalar wrapping
    assert ep.input_type == ["float32"]
    assert ep.input_size == [[1, 4]]


def test_model_endpoint_bad_engine(pk):
    with pytest.raises(ValueError):
        pk.ep.ModelEndpoint(engine_type="nope", serving_url="x")


def test_model_endpoint_bad_dtype(pk):
    with pytest.raises(ValueError):
        pk.ep.ModelEndpoint(engine_type="custom", serving_url="x", input_type=["notatype"])


def test_model_endpoint_requires_url(pk):
    with pytest.raises(ValueError):
        pk.ep.ModelEndpoint(engine_type="custom", serving_url="")


def test_multi_io_spec(pk):
    ep = pk.ep.ModelEndpoint(
        engine_type="jax",
        serving_url="multi",
        input_size=[[3], [5, 5]],
        input_type=["float32", "int32"],
        input_name=["a", "b"],
    )
    assert ep.input_size == [[3], [5, 5]]
    assert len(ep.input_type) == 2


def test_canary_validation(pk):
    with pytest.raises(ValueError):
        pk.ep.CanaryEP(endpoint="x", weights=[1], load_endpoints=["a"],
                       load_endpoint_prefix="p")
    with pytest.raises(ValueError):
        pk.ep.CanaryEP(endpoint="x", weights=[1])
    c = pk.ep.CanaryEP(endpoint="x", weights=[0.9, 0.1], load_endpoints=["a/1", "a/2"])
    assert pk.ep.CanaryEP.from_dict(c.as_dict()) == c


def test_monitoring(pk):
    m = pk.ep.ModelMonitoring(
        base_serving_url="auto_model",
        engine_type="jax",
        monitor_project="proj",
        max_versions=3,
    )
    assert pk.ep.ModelMonitoring.from_dict(m.as_dict()) == m


def test_metric_logging(pk):
    ml = pk.ep.EndpointMetricLogging(
        endpoint="ep",
        log_frequency=0.5,
        metrics={
            "x0": {"type": "scalar", "buckets": [0, 1, 2]},
            "label": pk.ep.MetricType(type="enum", buckets=["cat", "dog"]),
            "out": {"type": "value"},
        },
    )
    d = ml.as_dict()
    ml2 = pk.ep.EndpointMetricLogging.from_dict(d)
    assert ml2.metrics["x0"].type == "scalar"
    assert ml2.metrics["label"].buckets == ["cat", "dog"]
    with pytest.raises(ValueError):
        pk.ep.MetricType(type="scalar", buckets=None)
    with pytest.raises(ValueError):
        pk.ep.EndpointMetricLogging(endpoint="ep", log_frequency=2.0)


# -- request processor (test_request_processor.py) -------------------------


@pytest.fixture()
def mrp(pk, state_root, tmp_path):
    proc = _processor(pk, state_root=str(state_root), force_create=True, name="t")
    code = tmp_path / "echo.py"
    code.write_text(ECHO_CODE)
    proc.add_endpoint(
        pk.ep.ModelEndpoint(engine_type="custom", serving_url="echo"),
        preprocess_code=str(code),
    )
    proc.serialize()
    return proc


def test_fast_write_counter(pk):
    c = pk.mrp.FastWriteCounter()
    assert c.value() == 0
    c.inc()
    c.inc()
    c.dec()
    assert c.value() == 1
    assert c.value() == 1  # reading must not drift


def test_process_request(mrp):
    out = asyncio.run(mrp.process_request("echo", None, {"a": 1}))
    assert out == {"echo": {"a": 1}}


def test_missing_endpoint(pk, mrp):
    with pytest.raises(pk.mrp.EndpointNotFoundException):
        asyncio.run(mrp.process_request("nope", None, {}))


def test_serialize_roundtrip(pk, mrp, state_root):
    mrp.serialize()
    other = _processor(pk, service_id=mrp.get_id(), state_root=str(state_root))
    assert other.deserialize(skip_sync=True)
    assert "echo" in other.list_endpoints()
    # no-op when unchanged (config-hash detection)
    assert not other.deserialize(skip_sync=True)
    out = asyncio.run(other.process_request("echo", None, [1, 2]))
    assert out == {"echo": [1, 2]}


def test_remove_endpoint(pk, mrp):
    assert mrp.remove_endpoint("echo")
    assert not mrp.remove_endpoint("echo")
    with pytest.raises(pk.mrp.EndpointNotFoundException):
        asyncio.run(mrp.process_request("echo", None, {}))


def test_canary_routing(pk, mrp, tmp_path):
    code = tmp_path / "double.py"
    code.write_text(DOUBLE_CODE)
    mrp.add_endpoint(pk.ep.ModelEndpoint(engine_type="custom", serving_url="m/1"),
                     preprocess_code=str(code))
    mrp.add_endpoint(pk.ep.ModelEndpoint(engine_type="custom", serving_url="m/2"),
                     preprocess_code=str(code))
    mrp.add_canary_endpoint(
        pk.ep.CanaryEP(endpoint="m", weights=[1.0, 0.0], load_endpoints=["m/2", "m/1"]))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    # all traffic -> m/2 (weight 1.0)
    out = asyncio.run(mrp.process_request("m", None, {"x": [3]}))
    assert out == {"y": [6]}

    # prefix mode resolves to highest numeric version first
    mrp.add_canary_endpoint(pk.ep.CanaryEP(endpoint="p", weights=[1.0],
                                           load_endpoint_prefix="m/"))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    assert mrp._canary_route["p"]["endpoints"] == ["m/2"]

    # missing endpoints are skipped + weights renormalized
    mrp.add_canary_endpoint(
        pk.ep.CanaryEP(endpoint="q", weights=[0.5, 0.5], load_endpoints=["m/1", "gone/9"]))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    assert mrp._canary_route["q"]["endpoints"] == ["m/1"]
    assert mrp._canary_route["q"]["weights"] == [1.0]

    # prefix matching respects name boundaries: "m" must not match "m2/1"
    code2 = tmp_path / "double2.py"
    code2.write_text(DOUBLE_CODE)
    mrp.add_endpoint(pk.ep.ModelEndpoint(engine_type="custom", serving_url="m2/1"),
                     preprocess_code=str(code2))
    mrp.add_canary_endpoint(
        pk.ep.CanaryEP(endpoint="r", weights=[0.5, 0.5], load_endpoint_prefix="m"))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    assert set(mrp._canary_route["r"]["endpoints"]) == {"m/1", "m/2"}


def test_monitoring_auto_deploy(pk, mrp, tmp_path):
    reg = mrp.registry
    f = tmp_path / "m.txt"
    f.write_text("payload")
    code = tmp_path / "echo2.py"
    code.write_text(ECHO_CODE)
    mrp.add_model_monitoring(
        pk.ep.ModelMonitoring(base_serving_url="auto", engine_type="custom",
                              monitor_project="prod", max_versions=2),
        preprocess_code=str(code),
    )
    reg.register("model-a", project="prod", path=f)
    time.sleep(0.02)
    assert mrp._update_monitored_models()
    assert "auto/1" in mrp._model_monitoring_endpoints

    r2 = reg.register("model-b", project="prod", path=f)
    time.sleep(0.02)
    assert mrp._update_monitored_models()
    # monotone version numbers: newest model gets version 2
    eps = mrp._model_monitoring_endpoints
    assert set(eps) == {"auto/1", "auto/2"}
    assert eps["auto/2"].model_id == r2.id

    # a third model rolls the window (max_versions=2): auto/1 disappears
    r3 = reg.register("model-c", project="prod", path=f)
    time.sleep(0.02)
    assert mrp._update_monitored_models()
    eps = mrp._model_monitoring_endpoints
    assert set(eps) == {"auto/2", "auto/3"}
    assert eps["auto/3"].model_id == r3.id

    # monitored endpoints are servable
    out = asyncio.run(mrp.process_request("auto", "3", {"k": 1}))
    assert out == {"echo": {"k": 1}}


def test_stats_sampling(pk, mrp, tmp_path):
    broker_dir = tmp_path / "broker"
    mrp.configure(external_stats_broker="file://{}".format(broker_dir))
    mrp.add_metric_logging(
        pk.ep.EndpointMetricLogging(endpoint="echo", log_frequency=1.0, metrics={}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    for _ in range(5):
        asyncio.run(mrp.process_request("echo", None, {"x": 1}))
    batch = mrp._stats_queue.get_all(timeout=0.1)
    assert len(batch) == 5
    assert all(s["_url"] == "echo" and "_latency" in s and s["_count"] == 1 for s in batch)


def test_zero_downtime_swap_under_load(mrp):
    """Concurrent requests + a config swap: nothing drops, nothing errors."""

    async def run():
        async def client(n):
            results = []
            for i in range(n):
                results.append(await mrp.process_request("echo", None, i))
                await asyncio.sleep(0.001)
            return results

        async def swapper():
            await asyncio.sleep(0.01)
            mrp._last_update_hash = None  # force re-apply
            await asyncio.to_thread(mrp.deserialize)

        res, _ = await asyncio.gather(client(30), swapper())
        return res

    results = asyncio.run(run())
    assert len(results) == 30
    assert all(r == {"echo": i} for i, r in enumerate(results))


def test_hot_reload_preprocess_via_sync(mrp, tmp_path):
    """Re-uploading preprocess code under the same artifact name must take
    effect after the next sync (processor cache eviction on hash change)."""
    assert asyncio.run(mrp.process_request("echo", None, [1])) == {"echo": [1]}
    new_code = tmp_path / "echo_v2.py"
    new_code.write_text(ECHO_CODE.replace('{"echo": data}', '{"echo2": data}'))
    mrp.service.upload_artifact("py_code_echo", new_code)
    mrp._last_update_hash = None
    mrp.deserialize()
    assert asyncio.run(mrp.process_request("echo", None, [1])) == {"echo2": [1]}


def test_wildcard_no_cross_family(pk, mrp):
    mrp.add_metric_logging(
        pk.ep.EndpointMetricLogging(endpoint="model/*", log_frequency=0.5, metrics={}))
    assert mrp.get_endpoint_metric_logging("model/3") is not None
    assert mrp.get_endpoint_metric_logging("model2/3") is None


def test_metric_wildcard(pk, mrp):
    mrp.add_metric_logging(
        pk.ep.EndpointMetricLogging(endpoint="m/*", log_frequency=0.5, metrics={}))
    assert mrp.get_endpoint_metric_logging("m/7").log_frequency == 0.5
    assert mrp.get_endpoint_metric_logging("other") is None


# -- CLI (test_cli.py) -------------------------------------------------------


@pytest.fixture()
def svc_id(pk, state_root, capsys):
    assert pk.cli(["create", "--name", "cli-test"]) == 0
    out = capsys.readouterr().out
    return out.strip().rsplit("id=", 1)[-1]


def test_create_and_list(pk, svc_id, capsys):
    assert pk.cli(["list"]) == 0
    services = json.loads(capsys.readouterr().out)
    assert any(s["id"] == svc_id for s in services)


def test_model_upload_add_remove(pk, svc_id, tmp_path, capsys):
    cli = pk.cli
    code = tmp_path / "pre.py"
    code.write_text(ECHO_CODE)
    payload = tmp_path / "model.bin"
    payload.write_bytes(b"x")

    assert cli(["--yes", "--id", svc_id, "model", "upload", "--name", "m1",
                "--project", "p", "--path", str(payload), "--publish"]) == 0
    model_id = capsys.readouterr().out.strip().split("id=")[1].split()[0]

    assert cli(["--yes", "--id", svc_id, "model", "add", "--engine", "custom",
                "--endpoint", "test_model", "--model-id", model_id,
                "--preprocess", str(code)]) == 0
    capsys.readouterr()

    # model query path (--name instead of --model-id)
    assert cli(["--yes", "--id", svc_id, "model", "add", "--engine", "custom",
                "--endpoint", "test_model2", "--name", "m1", "--project", "p",
                "--published", "--preprocess", str(code)]) == 0
    out = capsys.readouterr().out
    assert model_id in out

    assert cli(["--yes", "--id", svc_id, "model", "list"]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert "test_model" in listed["endpoints"]
    assert listed["endpoints"]["test_model"]["model_id"] == model_id

    assert cli(["--yes", "--id", svc_id, "model", "remove",
                "--endpoint", "test_model"]) == 0
    capsys.readouterr()
    assert cli(["--yes", "--id", svc_id, "model", "list"]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert "test_model" not in listed["endpoints"]

    with pytest.raises(SystemExit):
        cli(["--yes", "--id", svc_id, "model", "remove", "--endpoint", "ghost"])


def test_canary_and_auto_update(pk, svc_id, tmp_path, capsys):
    cli = pk.cli
    code = tmp_path / "pre.py"
    code.write_text(ECHO_CODE)
    assert cli(["--yes", "--id", svc_id, "model", "auto-update", "--engine", "custom",
                "--endpoint", "auto_m", "--project", "prod", "--max-versions", "2",
                "--preprocess", str(code)]) == 0
    assert cli(["--yes", "--id", svc_id, "model", "canary", "--endpoint", "auto_m",
                "--weights", "0.1", "0.9",
                "--input-endpoint-prefix", "auto_m/"]) == 0
    capsys.readouterr()
    assert cli(["--yes", "--id", svc_id, "model", "list"]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert "auto_m" in listed["model_monitoring"]
    assert "auto_m" in listed["canary"]


def test_config_and_metrics(pk, svc_id, capsys):
    cli = pk.cli
    assert cli(["--yes", "--id", svc_id, "config",
                "--base-serve-url", "http://127.0.0.1:9090/serve",
                "--metric-log-freq", "0.5"]) == 0
    assert cli(["--yes", "--id", svc_id, "metrics", "add", "--endpoint", "test_model",
                "--log-freq", "1.0",
                "--variable-scalar", "x0=0/1/0.25", "x1=0,1,2,5",
                "--variable-enum", "label=cat,dog",
                "--variable-value", "rawval"]) == 0
    capsys.readouterr()
    assert cli(["--yes", "--id", svc_id, "metrics", "list"]) == 0
    listed = json.loads(capsys.readouterr().out)
    spec = listed["test_model"]
    assert spec["metrics"]["x0"]["buckets"] == [0.0, 0.25, 0.5, 0.75, 1.0]
    assert spec["metrics"]["x1"]["buckets"] == [0.0, 1.0, 2.0, 5.0]
    assert spec["metrics"]["label"]["type"] == "enum"
    assert spec["metrics"]["rawval"]["type"] == "value"

    # verify the config param round-trips into a processor
    mrp = _processor(pk, service_id=svc_id)
    mrp.deserialize(skip_sync=True)
    assert mrp._serving_base_url == "http://127.0.0.1:9090/serve"
    assert mrp._metric_log_freq == 0.5

    assert cli(["--yes", "--id", svc_id, "metrics", "remove", "--endpoint", "test_model",
                "--variable", "x1"]) == 0
    capsys.readouterr()
    assert cli(["--yes", "--id", svc_id, "metrics", "list"]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert "x1" not in listed["test_model"]["metrics"]


def test_aux_config_kv(pk, svc_id, tmp_path, capsys):
    code = tmp_path / "pre.py"
    code.write_text(ECHO_CODE)
    assert pk.cli(["--yes", "--id", svc_id, "model", "add", "--engine", "custom",
                   "--endpoint", "aux_ep", "--preprocess", str(code),
                   "--aux-config", "batching.buckets=[1,2,4]", "mesh.tp=8"]) == 0
    capsys.readouterr()
    assert pk.cli(["--yes", "--id", svc_id, "model", "list"]) == 0
    listed = json.loads(capsys.readouterr().out)
    aux = listed["endpoints"]["aux_ep"]["auxiliary_cfg"]
    assert aux == {"batching": {"buckets": [1, 2, 4]}, "mesh": {"tp": 8}}


# -- one state root, both packages -------------------------------------------


def _records(mrp):
    """Everything a processor read from the service document, as plain
    dicts."""
    return {
        "endpoints": {k: v.as_dict() for k, v in mrp.list_endpoints().items()},
        "monitoring": {k: v.as_dict() for k, v in mrp.list_model_monitoring().items()},
        "canary": {k: v.as_dict() for k, v in mrp.list_canary_endpoints().items()},
        "metrics": {k: v.as_dict() for k, v in mrp.list_endpoint_logging().items()},
        "canary_route": mrp._canary_route,
        "params": (mrp._serving_base_url, mrp._stats_broker_url, mrp._metric_log_freq),
    }


@pytest.mark.parametrize("writer", PACKAGES, ids=["reference_cli", "port_cli"])
def test_state_root_written_by_either_cli_is_read_alike_and_served_by_both(
        writer, state_root, tmp_path, capsys):
    """One package's CLI writes a service (endpoints with a preprocess
    artifact, a jax endpoint, an llm endpoint, a canary, a monitoring query,
    metric logging, the config); both packages' processors read equal
    records from it and serve its custom endpoints alike."""
    cli = _package(writer).cli
    code = tmp_path / "pre.py"
    code.write_text(DOUBLE_CODE)
    assert cli(["create", "--name", "shared"]) == 0
    svc_id = capsys.readouterr().out.strip().rsplit("id=", 1)[-1]
    base = ["--yes", "--id", svc_id]
    for ep in ("m/1", "m/2"):
        assert cli(base + ["model", "add", "--engine", "custom", "--endpoint", ep,
                           "--preprocess", str(code)]) == 0
    assert cli(base + ["model", "add", "--engine", "jax", "--endpoint", "clf",
                       "--model-id", "abc", "--input-size", "[1,4]",
                       "--input-type", "float32"]) == 0
    assert cli(base + ["model", "add", "--engine", "llm", "--endpoint", "chat",
                       "--aux-config", "engine.preset=llama-tiny",
                       "engine.chat.response_role=bot"]) == 0
    assert cli(base + ["model", "canary", "--endpoint", "m", "--weights", "1", "0",
                       "--input-endpoints", "m/2", "m/1"]) == 0
    assert cli(base + ["model", "auto-update", "--engine", "custom", "--endpoint", "auto",
                       "--project", "prod", "--max-versions", "2",
                       "--preprocess", str(code)]) == 0
    assert cli(base + ["config", "--base-serve-url", "http://127.0.0.1:9090/serve",
                       "--stats-broker", "file://{}".format(tmp_path / "broker"),
                       "--metric-log-freq", "0.25"]) == 0
    assert cli(base + ["metrics", "add", "--endpoint", "m/1", "--log-freq", "1.0",
                       "--variable-scalar", "x=0/1/0.5", "--variable-value", "y"]) == 0
    capsys.readouterr()

    readers = [_processor(_package(name), service_id=svc_id, state_root=str(state_root))
               for name in PACKAGES]
    records = []
    for mrp in readers:
        assert mrp.deserialize(skip_sync=True)
        records.append(_records(mrp))
    assert records[0] == records[1]
    assert set(records[0]["endpoints"]) == {"m/1", "m/2", "clf", "chat"}
    assert records[0]["canary_route"]["m"] == {"endpoints": ["m/2", "m/1"],
                                               "weights": [1.0, 0.0]}
    assert records[0]["metrics"]["m/1"]["log_frequency"] == 1.0
    assert records[0]["params"] == ("http://127.0.0.1:9090/serve",
                                    "file://{}".format(tmp_path / "broker"), 0.25)
    for mrp in readers:
        # the canary routes all traffic to m/2, which runs the uploaded code
        assert asyncio.run(mrp.process_request("m", None, {"x": [2, 5]})) == {"y": [4, 10]}
        assert asyncio.run(mrp.process_request("m/1", None, {"x": [1]})) == {"y": [2]}


def test_stop_ends_the_processor_threads_at_once(tmp_path):
    """``stop()`` returns with the sync daemon and the stats sender ended:
    each holds the processor (and its endpoints' engines) while it runs,
    and the sender's 5 s wait is cut short."""
    import gc
    import time
    import weakref

    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    mrp = ModelRequestProcessor(state_root=str(tmp_path), force_create=True, name="stop",
                                device="cpu")
    mrp.serialize()
    mrp.launch(poll_frequency_sec=300.0)
    threads = [mrp._sync_daemon, mrp._stats_sender]
    assert all(t.is_alive() for t in threads)
    t0 = time.monotonic()
    mrp.stop()
    assert time.monotonic() - t0 < 2.0
    assert not any(t.is_alive() for t in threads)
    ref = weakref.ref(mrp)
    del mrp
    gc.collect()
    assert ref() is None
