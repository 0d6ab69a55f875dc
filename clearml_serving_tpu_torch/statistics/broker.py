"""Pluggable statistics transport.

The port's copy of ``clearml_serving_tpu/statistics/broker.py``: the same
topic and packet format, so one broker serves either package.

The reference decouples request-time stats from the Prometheus exporter with a
Kafka topic (SURVEY.md §3.6). Kafka is not a hard dependency here — the broker
is a URL-selected transport with the same decoupled-queue shape:

- ``file:///path/to/dir``   — JSONL segment files on a shared filesystem; the
  consumer tails them. Zero-dependency default for single-host / shared-volume
  deployments.
- ``kafka://host:port``     — Kafka topic (requires kafka-python; gated).
- ``""`` (empty)            — stats dropped (best-effort contract, same as the
  reference when no broker is configured).

Producers are best-effort and must never raise into the serving hot path.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

TOPIC = "tpuserve_inference_stats"


class FileBrokerProducer:
    """Append-only JSONL segments, one file per producer instance (no
    cross-process write contention); consumers tail the directory."""

    def __init__(self, directory: str):
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._path = self._dir / "{}_{}.jsonl".format(TOPIC, uuid.uuid4().hex[:12])

    def send_batch(self, batch: List[Dict[str, Any]]) -> None:
        with open(self._path, "a") as f:
            for item in batch:
                f.write(json.dumps(item) + "\n")


class FileBrokerConsumer:
    """Tails every segment file in the directory, remembering per-file offsets."""

    def __init__(self, directory: str):
        self._dir = Path(directory)
        self._offsets: Dict[str, int] = {}

    def poll(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        if not self._dir.is_dir():
            return out
        for seg in sorted(self._dir.glob("{}_*.jsonl".format(TOPIC))):
            key = seg.name
            offset = self._offsets.get(key, 0)
            try:
                with open(seg, "r") as f:
                    f.seek(offset)
                    for line in f:
                        if not line.endswith("\n"):
                            break  # partial write; re-read next poll
                        try:
                            out.append(json.loads(line))
                        except json.JSONDecodeError:
                            pass
                        offset += len(line.encode("utf-8"))
                self._offsets[key] = offset
            except OSError:
                continue
        return out


class KafkaBrokerProducer:
    def __init__(self, bootstrap: str):
        from kafka import KafkaProducer  # gated dependency

        self._producer = KafkaProducer(
            bootstrap_servers=bootstrap,
            value_serializer=lambda v: json.dumps(v).encode("utf-8"),
        )

    def send_batch(self, batch: List[Dict[str, Any]]) -> None:
        for item in batch:
            self._producer.send(TOPIC, item)
        self._producer.flush(timeout=10)


class KafkaBrokerConsumer:
    def __init__(self, bootstrap: str):
        from kafka import KafkaConsumer

        self._consumer = KafkaConsumer(
            TOPIC,
            bootstrap_servers=bootstrap,
            value_deserializer=lambda b: json.loads(b.decode("utf-8")),
            auto_offset_reset="earliest",
        )

    def poll(self) -> List[Dict[str, Any]]:
        records = self._consumer.poll(timeout_ms=1000)
        return [rec.value for recs in records.values() for rec in recs]


def make_producer(url: str):
    if not url:
        return None
    if url.startswith("file://"):
        return FileBrokerProducer(url[len("file://"):])
    if url.startswith("kafka://"):
        return KafkaBrokerProducer(url[len("kafka://"):])
    # bare path == file broker
    return FileBrokerProducer(url)


def make_consumer(url: str):
    if not url:
        return None
    if url.startswith("file://"):
        return FileBrokerConsumer(url[len("file://"):])
    if url.startswith("kafka://"):
        return KafkaBrokerConsumer(url[len("kafka://"):])
    return FileBrokerConsumer(url)
