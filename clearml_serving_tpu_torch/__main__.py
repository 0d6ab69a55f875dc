"""Operator CLI.

Command-tree parity with the reference CLI (clearml_serving/__main__.py:332-630):
``create``, ``list``, ``config``, ``model {add, remove, upload, canary,
auto-update, list}``, ``metrics {add, remove, list}``.

Same offline mutation pattern as the reference (:141-143): the CLI never talks
to a live serving container — it opens the control-plane service document,
``deserialize(skip_sync=True)`` → mutate in-memory maps → ``serialize()``;
running routers pick the change up on their next poll.

The port's copy of ``clearml_serving_tpu/__main__.py``: the same commands,
flags and service document, so a state root written here is served by
either package's processor. Installed as ``tpu-serving-torch``; run as
``python -m clearml_serving_tpu_torch``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from .serving.endpoints import (
    CanaryEP,
    EndpointMetricLogging,
    MetricType,
    ModelEndpoint,
    ModelMonitoring,
)
from .serving.model_request_processor import ModelRequestProcessor
from .version import __version__

VERBOSE = False


def _open_processor(args, force_create=False, name=None) -> ModelRequestProcessor:
    processor = ModelRequestProcessor(
        service_id=getattr(args, "id", None),
        force_create=force_create,
        name=name,
    )
    if not force_create:
        _verify_session_version(processor, assume_yes=getattr(args, "yes", False))
        processor.deserialize(skip_sync=True)
    return processor


def _verify_session_version(processor: ModelRequestProcessor, assume_yes: bool) -> None:
    """Warn when CLI major.minor differs from the service's stored version
    (reference __main__.py:24-40)."""
    stored = processor.get_version()
    cur = ".".join(__version__.split(".")[:2])
    got = ".".join(str(stored).split(".")[:2])
    if cur != got:
        if assume_yes:
            return
        answer = input(
            "Warning: serving service version {} does not match CLI version {} — "
            "continue? [y/N] ".format(stored, __version__)
        )
        if answer.strip().lower() not in ("y", "yes"):
            sys.exit(1)


def _parse_aux_config(args) -> Optional[dict]:
    """--aux-config as a file (json) or key=value pairs (reference :295-304)."""
    aux = getattr(args, "aux_config", None)
    if not aux:
        return None
    if len(aux) == 1 and aux[0].endswith((".json", ".cfg", ".conf")):
        with open(aux[0]) as f:
            return json.load(f)
    out = {}
    for kv in aux:
        if "=" not in kv:
            raise SystemExit("--aux-config entries must be key=value or a .json file")
        key, value = kv.split("=", 1)
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        # dotted keys nest: batching.buckets=[1,2] -> {"batching": {"buckets": ...}}
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _io_spec_kwargs(args) -> dict:
    return dict(
        input_size=getattr(args, "input_size", None),
        input_type=getattr(args, "input_type", None),
        input_name=getattr(args, "input_name", None),
        output_size=getattr(args, "output_size", None),
        output_type=getattr(args, "output_type", None),
        output_name=getattr(args, "output_name", None),
    )


# ---------------------------------------------------------------- commands


def func_create_service(args):
    processor = ModelRequestProcessor(
        force_create=True,
        name=args.name or "tpu-serving",
        project=args.project,
        tags=args.tags,
    )
    processor.serialize()
    print("New serving service created: id={}".format(processor.get_id()))


def func_list_services(args):
    services = ModelRequestProcessor.list_control_plane_services()
    print(json.dumps(services, indent=2, default=str))


def func_config_service(args):
    processor = _open_processor(args)
    processor.configure(
        external_serving_base_url=args.base_serve_url,
        external_engine_grpc_address=args.engine_grpc_server,
        external_stats_broker=args.stats_broker,
        default_metric_log_freq=args.metric_log_freq,
    )
    print("Serving service {} configured".format(processor.get_id()))


def func_model_upload(args):
    processor = _open_processor(args)
    if not args.path and not args.url:
        raise SystemExit("model upload requires --path or --url")
    record = processor.registry.register(
        name=args.name,
        project=args.project,
        tags=args.tags,
        framework=args.framework,
        path=args.path,
        uri=args.url,
        publish=bool(args.publish),
    )
    print("Model uploaded: id={} name={}".format(record.id, record.name))


def func_model_list(args):
    processor = _open_processor(args)
    out = {
        "endpoints": {k: v.as_dict(remove_null_entries=True) for k, v in processor.list_endpoints().items()},
        "model_monitoring": {
            k: v.as_dict(remove_null_entries=True) for k, v in processor.list_model_monitoring().items()
        },
        "canary": {k: v.as_dict(remove_null_entries=True) for k, v in processor.list_canary_endpoints().items()},
    }
    print(json.dumps(out, indent=2, default=str))


def func_model_remove(args):
    processor = _open_processor(args)
    if processor.remove_endpoint(args.endpoint):
        kind = "endpoint"
    elif processor.remove_model_monitoring(args.endpoint):
        kind = "model monitoring"
    elif processor.remove_canary_endpoint(args.endpoint):
        kind = "canary"
    else:
        raise SystemExit("endpoint {!r} not found".format(args.endpoint))
    processor.serialize()
    print("Removed {} {!r}".format(kind, args.endpoint))


def func_model_endpoint_add(args):
    processor = _open_processor(args)
    endpoint = ModelEndpoint(
        engine_type=args.engine,
        serving_url=args.endpoint,
        model_id=args.model_id,
        version=args.version,
        auxiliary_cfg=_parse_aux_config(args),
        **_io_spec_kwargs(args),
    )
    if not args.model_id and (args.name or args.project or args.tags):
        records = processor.registry.query(
            project=args.project, name=args.name, tags=args.tags,
            only_published=args.published, max_results=1,
        )
        if not records:
            raise SystemExit("no model found matching the query")
        endpoint.model_id = records[0].id
        print("Selected model id={}".format(endpoint.model_id))
    url = processor.add_endpoint(endpoint, preprocess_code=args.preprocess)
    processor.serialize()
    print("Endpoint {!r} added".format(url))


def func_model_auto_update_add(args):
    processor = _open_processor(args)
    monitoring = ModelMonitoring(
        base_serving_url=args.endpoint,
        engine_type=args.engine,
        monitor_project=args.project,
        monitor_name=args.name,
        monitor_tags=args.tags,
        only_published=args.published,
        max_versions=args.max_versions,
        auxiliary_cfg=_parse_aux_config(args),
        **_io_spec_kwargs(args),
    )
    name = processor.add_model_monitoring(monitoring, preprocess_code=args.preprocess)
    processor.serialize()
    print("Model auto-update {!r} added".format(name))


def func_canary_add(args):
    processor = _open_processor(args)
    canary = CanaryEP(
        endpoint=args.endpoint,
        weights=args.weights,
        load_endpoints=args.input_endpoints or [],
        load_endpoint_prefix=args.input_endpoint_prefix,
    )
    processor.add_canary_endpoint(canary)
    processor.serialize()
    print("Canary endpoint {!r} added".format(args.endpoint))


def func_metrics_add(args):
    processor = _open_processor(args)
    metrics = {}
    for spec in args.variable_scalar or []:
        name, buckets = spec.split("=", 1)
        if "/" in buckets:
            lo, hi, step = (float(v) for v in buckets.split("/"))
            bucket_list = []
            v = lo
            while v <= hi + 1e-9:
                bucket_list.append(round(v, 9))
                v += step
        else:
            bucket_list = [float(v) for v in buckets.split(",") if v != ""]
        metrics[name] = MetricType(type="scalar", buckets=bucket_list)
    for spec in args.variable_enum or []:
        name, values = spec.split("=", 1)
        metrics[name] = MetricType(type="enum", buckets=values.split(","))
    for name in args.variable_value or []:
        metrics[name] = MetricType(type="value")
    for name in args.variable_counter or []:
        metrics[name] = MetricType(type="counter")
    processor.add_metric_logging(
        EndpointMetricLogging(
            endpoint=args.endpoint, log_frequency=args.log_freq, metrics=metrics
        )
    )
    processor.serialize()
    print("Metrics logging added for {!r}".format(args.endpoint))


def func_metrics_remove(args):
    processor = _open_processor(args)
    if args.variable:
        for var in args.variable:
            processor.remove_metric_logging(args.endpoint, var)
    else:
        processor.remove_metric_logging(args.endpoint)
    processor.serialize()
    print("Metrics removed for {!r}".format(args.endpoint))


def func_metrics_list(args):
    processor = _open_processor(args)
    out = {k: v.as_dict() for k, v in processor.list_endpoint_logging().items()}
    print(json.dumps(out, indent=2, default=str))


# ---------------------------------------------------------------- parser


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu-serving-torch",
        description="Model-serving CLI of the PyTorch port (clearml-serving capability parity)",
    )
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--yes", action="store_true", help="assume yes on prompts")
    parser.add_argument("--id", type=str, default=None, help="serving service id")
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("create", help="create a new serving service")
    p.add_argument("--name", type=str, default="tpu-serving")
    p.add_argument("--project", type=str, default="DevOps")
    p.add_argument("--tags", nargs="+", default=None)
    p.set_defaults(func=func_create_service)

    p = sub.add_parser("list", help="list serving services")
    p.set_defaults(func=func_list_services)

    p = sub.add_parser("config", help="configure the serving service")
    p.add_argument("--base-serve-url", type=str, default=None)
    p.add_argument("--engine-grpc-server", type=str, default=None)
    p.add_argument("--stats-broker", type=str, default=None)
    p.add_argument("--metric-log-freq", type=float, default=None)
    p.set_defaults(func=func_config_service)

    model = sub.add_parser("model", help="model endpoint management")
    model_sub = model.add_subparsers(dest="model_command")

    p = model_sub.add_parser("list", help="list model endpoints")
    p.set_defaults(func=func_model_list)

    p = model_sub.add_parser("remove", help="remove an endpoint/monitoring/canary")
    p.add_argument("--endpoint", type=str, required=True)
    p.set_defaults(func=func_model_remove)

    p = model_sub.add_parser("upload", help="upload/register a model")
    p.add_argument("--name", type=str, required=True)
    p.add_argument("--project", type=str, default=None)
    p.add_argument("--tags", nargs="+", default=None)
    p.add_argument("--framework", type=str, default=None)
    p.add_argument("--path", type=str, default=None)
    p.add_argument("--url", type=str, default=None)
    p.add_argument("--publish", action="store_true")
    p.set_defaults(func=func_model_upload)

    def _add_io_spec(p):
        p.add_argument("--input-size", nargs="+", type=json.loads, default=None,
                       help="input shapes, e.g. --input-size [1,4]")
        p.add_argument("--input-type", nargs="+", type=str, default=None)
        p.add_argument("--input-name", nargs="+", type=str, default=None)
        p.add_argument("--output-size", nargs="+", type=json.loads, default=None)
        p.add_argument("--output-type", nargs="+", type=str, default=None)
        p.add_argument("--output-name", nargs="+", type=str, default=None)
        p.add_argument("--aux-config", nargs="+", default=None,
                       help="key=value pairs or a .json file")
        p.add_argument("--preprocess", type=str, default=None,
                       help="preprocess code file or package dir")

    p = model_sub.add_parser("add", help="add a static model endpoint")
    p.add_argument("--engine", type=str, required=True)
    p.add_argument("--endpoint", type=str, required=True)
    p.add_argument("--version", type=str, default=None)
    p.add_argument("--model-id", type=str, default=None)
    p.add_argument("--name", type=str, default=None, help="model query: name")
    p.add_argument("--project", type=str, default=None, help="model query: project")
    p.add_argument("--tags", nargs="+", default=None, help="model query: tags")
    p.add_argument("--published", action="store_true")
    _add_io_spec(p)
    p.set_defaults(func=func_model_endpoint_add)

    p = model_sub.add_parser("auto-update", help="add a model auto-deploy query")
    p.add_argument("--engine", type=str, required=True)
    p.add_argument("--endpoint", type=str, required=True)
    p.add_argument("--max-versions", type=int, default=None)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--project", type=str, default=None)
    p.add_argument("--tags", nargs="+", default=None)
    p.add_argument("--published", action="store_true")
    _add_io_spec(p)
    p.set_defaults(func=func_model_auto_update_add)

    p = model_sub.add_parser("canary", help="add a canary/A-B endpoint")
    p.add_argument("--endpoint", type=str, required=True)
    p.add_argument("--weights", nargs="+", type=float, required=True)
    p.add_argument("--input-endpoints", nargs="+", default=None)
    p.add_argument("--input-endpoint-prefix", type=str, default=None)
    p.set_defaults(func=func_canary_add)

    metrics = sub.add_parser("metrics", help="statistics logging management")
    metrics_sub = metrics.add_subparsers(dest="metrics_command")

    p = metrics_sub.add_parser("add", help="add logged metrics for an endpoint")
    p.add_argument("--endpoint", type=str, required=True)
    p.add_argument("--log-freq", type=float, default=None)
    p.add_argument("--variable-scalar", nargs="+", default=None,
                   help="name=min/max/step or name=v1,v2,...")
    p.add_argument("--variable-enum", nargs="+", default=None, help="name=a,b,c")
    p.add_argument("--variable-value", nargs="+", default=None)
    p.add_argument("--variable-counter", nargs="+", default=None)
    p.set_defaults(func=func_metrics_add)

    p = metrics_sub.add_parser("remove", help="remove logged metrics")
    p.add_argument("--endpoint", type=str, required=True)
    p.add_argument("--variable", nargs="+", default=None)
    p.set_defaults(func=func_metrics_remove)

    p = metrics_sub.add_parser("list", help="list logged metrics")
    p.set_defaults(func=func_metrics_list)

    args = parser.parse_args(argv)
    global VERBOSE
    VERBOSE = bool(args.debug)
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    args.func(args)
    return 0


def main():
    try:
        sys.exit(cli())
    except KeyboardInterrupt:
        sys.exit(130)
    except SystemExit:
        raise
    except Exception as ex:
        if VERBOSE:
            raise
        print("Error: {}".format(ex), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
