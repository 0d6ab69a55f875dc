"""Statistics service entry point (``tpu-serving-torch-statistics``).

The port's copy of ``clearml_serving_tpu/statistics/main.py``: consumes the
stats broker and exposes a Prometheus scrape endpoint on
``TPUSERVE_STATS_PORT`` (default 9999). The broker URL comes from
``TPUSERVE_STATS_BROKER`` or, failing that, from the service's
``stats_broker`` parameter (``TPUSERVE_SERVICE_ID`` names the service,
``TPUSERVE_STATE_ROOT`` its state root). The service builds no engine and
makes no CUDA context: its processor only reads the endpoints' metric
specs.
"""

from __future__ import annotations

import os

from prometheus_client import start_http_server

from .metrics import StatisticsController
from ..serving.model_request_processor import ModelRequestProcessor


def main() -> None:
    service_id = os.environ.get("TPUSERVE_SERVICE_ID") or None
    broker_url = os.environ.get("TPUSERVE_STATS_BROKER", "")
    port = int(os.environ.get("TPUSERVE_STATS_PORT", 9999))
    poll_freq_min = float(os.environ.get("TPUSERVE_POLL_FREQ", 1.0))

    processor = None
    try:
        processor = ModelRequestProcessor(service_id=service_id)
        if not broker_url:
            broker_url = processor._service.get_parameters().get("stats_broker") or ""
    except Exception as ex:
        print("statistics: no control-plane service ({}) — reserved metrics only".format(ex))

    if not broker_url:
        raise SystemExit(
            "statistics: no stats broker configured "
            "(TPUSERVE_STATS_BROKER or `python -m clearml_serving_tpu_torch config "
            "--stats-broker`)"
        )

    start_http_server(port)
    print("statistics: Prometheus scrape endpoint on :{}".format(port))
    controller = StatisticsController(
        broker_url, processor=processor, poll_frequency_sec=poll_freq_min * 60.0
    )
    controller.start()


if __name__ == "__main__":
    main()
