"""Batch ingestion: job spec → segments → push (the port of
pinot_tpu/ingestion/batch.py).

Reference analogue: the batch ingestion spec model (pinot-spi/.../spi/
ingestion/batch/spec/SegmentGenerationJobSpec.java — YAML job files), the
standalone runner (pinot-plugins/pinot-batch-ingestion/
pinot-batch-ingestion-standalone/ SegmentGenerationJobRunner), and
IngestionJobLauncher + SegmentPushUtils (SURVEY.md §3.4): per input file,
RecordReader → TransformPipeline → two-pass segment build → push (copy to
deep store + controller metadata registration).

The segment build is host code, so a job (and each spawned worker of the
multiprocess runner, which imports only this package) touches no card; the
servers that load the pushed segments put them on their device. One
addition to the JAX package's results: ``SegmentGenerationResult.timings_ms``
holds the file's read, transform, build and upload milliseconds, measured
where the file was processed (the worker, for the multiprocess runner).
"""

from __future__ import annotations

import tarfile
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..plugins.inputformat import create_record_reader
from ..segment.builder import SegmentBuilder
from ..spi.data_types import Schema
from ..spi.filesystem import get_fs
from ..spi.table_config import TableConfig
from .transform import build_transform_pipeline


@dataclass
class SegmentGenerationJobSpec:
    """Reference: SegmentGenerationJobSpec.java (11 spec classes collapsed
    to the fields the runner consumes)."""

    input_dir_uri: str
    output_dir_uri: str
    schema: Schema
    table_config: TableConfig
    input_format: Optional[str] = None  # None → infer per file extension
    record_reader_config: dict = field(default_factory=dict)
    include_file_name_pattern: Optional[str] = None  # glob, e.g. "*.csv"
    segment_name_prefix: Optional[str] = None
    overwrite_output: bool = True
    create_tar: bool = False  # reference pushes tar.gz; dirs are the default here
    # standalone = in-process sequential; multiprocess = one build per
    # worker process (the Spark/Hadoop runner analogue — the reference
    # distributes file→segment tasks over executors,
    # pinot-plugins/pinot-batch-ingestion/pinot-batch-ingestion-spark-3/
    # SparkSegmentGenerationJobRunner; here the unit of distribution is a
    # local process pool, and the FS abstraction keeps inputs/outputs on
    # shared/object storage exactly as the cluster runners do)
    execution_framework: str = "standalone"
    parallelism: Optional[int] = None  # multiprocess worker count
    # module imported in each worker before building — re-registers
    # process-global state (custom index types, stream decoders) that a
    # spawned worker would not inherit (reference: plugin jars shipped to
    # Spark executors via --jars)
    worker_setup_module: Optional[str] = None

    @classmethod
    def from_yaml(cls, path: str, schema: Schema,
                  table_config: TableConfig) -> "SegmentGenerationJobSpec":
        import yaml

        d = yaml.safe_load(Path(path).read_text())
        rr = d.get("recordReaderSpec", {})
        return cls(
            input_dir_uri=d["inputDirURI"],
            output_dir_uri=d["outputDirURI"],
            schema=schema,
            table_config=table_config,
            input_format=rr.get("dataFormat"),
            record_reader_config=rr.get("configs", {}) or {},
            include_file_name_pattern=d.get("includeFileNamePattern"),
            segment_name_prefix=(d.get("segmentNameGeneratorSpec", {}) or {})
            .get("configs", {}).get("segment.name.prefix"),
        )


@dataclass
class SegmentGenerationResult:
    segment_name: str
    output_uri: str
    num_docs: int
    rows_filtered: int
    # {col: [partition ids]} from builder stamping (segmentPartitionConfig)
    partitions: dict = field(default_factory=dict)
    # {"read", "transform", "build", "upload"}: ms spent on the file
    timings_ms: dict = field(default_factory=dict)


class IngestionJobLauncher:
    """Reference: IngestionJobLauncher.runIngestionJob — resolves input
    files, runs one segment build per file, pushes outputs."""

    def __init__(self, spec: SegmentGenerationJobSpec):
        self.spec = spec

    def list_input_files(self) -> list[str]:
        fs = get_fs(self.spec.input_dir_uri)
        files = fs.list_files(self.spec.input_dir_uri, recursive=True)
        pat = self.spec.include_file_name_pattern
        if pat:
            from fnmatch import fnmatch

            files = [f for f in files if fnmatch(Path(f).name, pat)]
        return files

    def run(self) -> list[SegmentGenerationResult]:
        files = self.list_input_files()
        if not files:
            raise FileNotFoundError(
                f"no input files under {self.spec.input_dir_uri}")
        out_fs = get_fs(self.spec.output_dir_uri)
        out_fs.mkdir(self.spec.output_dir_uri)
        fw = self.spec.execution_framework
        if fw == "multiprocess" and len(files) > 1:
            import concurrent.futures as cf
            import multiprocessing
            import os

            workers = self.spec.parallelism or min(len(files),
                                                   os.cpu_count() or 1)
            # spawn, explicitly: fork from a threaded parent can deadlock,
            # and spawn makes worker state deterministic everywhere — any
            # process-global registrations come back via worker_setup_module
            with cf.ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_worker_init,
                    initargs=(self.spec.worker_setup_module,)) as pool:
                futs = [pool.submit(_generate_one_job, self.spec, path, seq)
                        for seq, path in enumerate(files)]
                # fail-fast like the reference runners: one failed file
                # task fails the job (results keep input order)
                return [f.result() for f in futs]
        if fw not in ("standalone", "multiprocess"):
            raise ValueError(
                f"unknown executionFrameworkSpec {fw!r} "
                "(standalone | multiprocess)")
        return [self._generate_one(path, seq)
                for seq, path in enumerate(files)]

    def _generate_one(self, path: str, seq: int) -> SegmentGenerationResult:
        return _generate_one_job(self.spec, path, seq)


def _worker_init(setup_module: Optional[str]) -> None:
    if setup_module:
        import importlib

        importlib.import_module(setup_module)


def upload_segment_from_rows(schema: Schema, table_config, segment_name: str,
                             rows, out_dir_uri: str,
                             create_tar: bool = False,
                             timings_ms: Optional[dict] = None
                             ) -> tuple[str, dict]:
    """Rows → two-pass segment build → upload to the output FS. Returns
    (out_uri, partition stamps). The ONE build-and-upload recipe shared by
    the batch runners and the streaming sink, so metadata (partition
    stamps, tar layout) can't diverge between push paths. ``timings_ms``,
    where given, gains the "build" and "upload" (tar + copy) ms."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        local = Path(tmp) / segment_name
        SegmentBuilder(schema, table_config, segment_name) \
            .build_from_rows(rows, local)
        t1 = time.perf_counter()
        from ..segment.format import partition_push_metadata

        parts = partition_push_metadata(local).get("partitions", {})
        out_uri = f"{out_dir_uri.rstrip('/')}/{segment_name}"
        fs = get_fs(out_dir_uri)
        fs.mkdir(out_dir_uri)
        if create_tar:
            tar_path = Path(tmp) / f"{segment_name}.tar.gz"
            with tarfile.open(tar_path, "w:gz") as tf:
                tf.add(local, arcname=segment_name)
            out_uri += ".tar.gz"
            fs.copy_from_local(str(tar_path), out_uri)
        else:
            fs.copy_from_local(str(local), out_uri)
        if timings_ms is not None:
            timings_ms["build"] = (t1 - t0) * 1e3
            timings_ms["upload"] = (time.perf_counter() - t1) * 1e3
    return out_uri, parts


# the end of a reader's records: a reader may yield None (a JSON `null`),
# which dict() refuses as it does in a plain loop
_END = object()


def _generate_one_job(spec: SegmentGenerationJobSpec, path: str,
                      seq: int) -> SegmentGenerationResult:
    """File → segment → push, self-contained so worker processes can run it
    (reference: SegmentGenerationTaskRunner inside each Spark executor)."""
    prefix = spec.segment_name_prefix or spec.table_config.table_name
    segment_name = f"{prefix}_{seq}"
    reader = create_record_reader(path, spec.input_format,
                                  spec.record_reader_config)
    pipeline = build_transform_pipeline(spec.schema, spec.table_config)
    rows = []
    filtered = 0
    read_s = transform_s = 0.0
    clock = time.perf_counter
    it = iter(reader)
    while True:
        t0 = clock()
        raw = next(it, _END)
        t1 = clock()
        read_s += t1 - t0
        if raw is _END:
            break
        row = pipeline.transform(dict(raw))
        transform_s += clock() - t1
        if row is None:
            filtered += 1
            continue
        rows.append(row)
    timings = {"read": read_s * 1e3, "transform": transform_s * 1e3}
    out_uri, parts = upload_segment_from_rows(
        spec.schema, spec.table_config, segment_name, rows,
        spec.output_dir_uri, create_tar=spec.create_tar, timings_ms=timings)
    return SegmentGenerationResult(segment_name, out_uri, len(rows), filtered,
                                   partitions=parts, timings_ms=timings)


def push_segments_to_cluster(results: list[SegmentGenerationResult],
                             controller, table_name_with_type: str,
                             extra_meta: Optional[dict] = None) -> None:
    """Metadata push (reference: SegmentPushUtils → controller
    /v2/segments): register each built segment's location + doc count with
    the cluster controller, which assigns replicas and updates the ideal
    state. ``extra_meta`` merges into every segment's metadata (e.g. the
    distributed runner's ``inputFile`` dedup marker)."""
    for r in results:
        meta = {"location": r.output_uri, "numDocs": r.num_docs}
        if r.partitions:
            meta["partitions"] = r.partitions
        if extra_meta:
            meta.update(extra_meta)
        controller.add_segment(table_name_with_type, r.segment_name, meta)


def untar_segment(tar_uri: str, dest_dir: str) -> str:
    """Server-side fetch+untar (reference: SegmentFetcherFactory + untar on
    OFFLINE→ONLINE). The tarball streams through the file system's
    ``open`` into ``dest_dir``, with no local copy of it first."""
    with get_fs(tar_uri).open(tar_uri) as f, \
            tarfile.open(fileobj=f, mode="r|gz") as tf:
        tf.extractall(dest_dir, filter="data")
    name = Path(tar_uri).name
    for suffix in (".tar.gz", ".tgz"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return str(Path(dest_dir) / name)
