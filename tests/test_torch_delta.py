"""Delta Lake through the port's session against the JAX package's, on
the CPU.

The same steps run through both packages over small tables (a few
hundred to a few thousand rows): writes, appends and an overwrite, the
automatic checkpoint of the tenth commit, DELETE, UPDATE and MERGE with
their file pruning, deletion-vector DELETEs (a second one that unions
with the first's vectors, one that deletes a whole file, one whose vector
outgrows the inline limit) and an UPDATE over the vectors, on a table of
several files. Each commit's actions must equal the reference's, uuids,
paths, sizes and timestamps aside, stats JSON, prunedFiles and inline
deletion vectors included; every read equals the reference's row for
row. The port runs once on each engine (fused and adaptive); the
reference once a module. Beside them: the column-mapping read, the empty
table, the DV codec's bytes, tables read across the two packages, a
deterministic commit conflict, createDataFrame from each input kind, and
each refusal that names a ROADMAP item. Reads compare exactly (doubles
bit for bit: no arithmetic runs on them).
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSparkSession as JaxSession
from spark_rapids_tpu.lakehouse import deletion_vectors as JDV
from spark_rapids_tpu.lakehouse import delta as JD
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.session import TpuSparkSession
from spark_rapids_tpu_torch.lakehouse import deletion_vectors as PDV
from spark_rapids_tpu_torch.lakehouse import delta as PD

ENGINES = ("fused", "aqe")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: beside the other test workers' pools its
    intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(engine: str = "fused", **conf) -> TpuSparkSession:
    return TpuSparkSession({
        "spark.rapids.torch.device": "cpu",
        "spark.sql.shuffle.partitions": 2,
        "spark.rapids.sql.fusedExec.enabled": engine == "fused",
        "spark.rapids.tpu.io.retry.backoffMs": 1, **conf})


def _jax() -> JaxSession:
    return JaxSession({"spark.sql.shuffle.partitions": 2,
                       "spark.rapids.tpu.io.retry.backoffMs": 1})


def _table(lo: int, n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": pa.array(np.arange(lo, lo + n), type=pa.int64()),
        "v": pa.array(rng.random(n), type=pa.float64()),
        "tag": pa.array([f"t{i % 5}" for i in range(n)], type=pa.string()),
        "d": pa.array((np.arange(n) % 400 + 8000).astype(np.int32),
                      type=pa.date32()),
    })


#: action fields that differ from run to run
_VOLATILE = {"path", "size", "modificationTime", "deletionTimestamp",
             "timestamp", "id", "createdTime"}


def _norm(obj):
    if isinstance(obj, list):
        return [_norm(x) for x in obj]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        if k in _VOLATILE:
            continue
        if k == "stats" and isinstance(v, str):
            out[k] = json.loads(v)
        elif k == "deletionVector" and v.get("storageType") == "u":
            # a sidecar's name is a uuid; its bytes are compared apart
            out[k] = {a: b for a, b in v.items() if a != "pathOrInlineDv"}
        else:
            out[k] = _norm(v)
    return out


def _log(path: str) -> list:
    """Every commit's actions, normalised, as sorted canonical JSON (the
    order of a commit's per-file actions follows the files' uuid names)."""
    out = []
    v = 0
    while os.path.exists(PD._commit_file(path, v)):
        with open(PD._commit_file(path, v)) as f:
            out.append(sorted(json.dumps(_norm(json.loads(line)),
                                         sort_keys=True)
                              for line in f if line.strip()))
        v += 1
    return out


def _sidecars(path: str) -> list:
    """The deletion-vector files' bytes, sorted."""
    return sorted(open(os.path.join(path, f), "rb").read()
                  for f in os.listdir(path)
                  if f.startswith("deletion_vector_"))


def _rows(t: pa.Table) -> pa.Table:
    return t.sort_by([(c, "ascending") for c in t.column_names])


def _log_scenario(spark, F, D, root: str) -> dict:
    """Four appended files of disjoint ids, DELETE / UPDATE / MERGE with
    pruning, an overwrite and appends up to the automatic checkpoint."""
    p = os.path.join(root, "log")
    for i, lo in enumerate((0, 1000, 2000, 3000)):
        (spark.createDataFrame(_table(lo, 400, lo)).write.format("delta")
         .mode("error" if i == 0 else "append").save(p))
    dt = D.DeltaTable.forPath(spark, p)
    dt.delete(F.col("id") < 100)
    dt.delete(F.col("id") > 99_999)  # provably empty: no commit
    dt.update(F.col("id") >= 3300, {"tag": "u"})
    dt.merge(spark.createDataFrame(_table(1350, 100, 9)), "id") \
        .whenMatchedUpdateAll().whenNotMatchedInsertAll().execute()
    dt.merge(spark.createDataFrame(pa.table({"id": pa.array(
        [2000, 2001, 2390], type=pa.int64())})), "id") \
        .whenMatchedDelete().execute()
    after_dml = spark.read.delta(p).collect_arrow()
    spark.createDataFrame(_table(7000, 30, 7)).write.format("delta") \
        .mode("overwrite").save(p)
    for lo in (8000, 8100):
        spark.createDataFrame(_table(lo, 20, lo)).write.format("delta") \
            .mode("append").save(p)
    snap = D.load_snapshot(p)
    cp = os.path.join(p, "_delta_log", f"{10:020d}.checkpoint.parquet")
    return dict(log=_log(p), after_dml=_rows(after_dml),
                final=_rows(spark.read.format("delta").load(p)
                            .collect_arrow()),
                version=snap.version, files=len(snap.files),
                checkpoint=_norm(pq.read_table(cp).to_pylist()),
                last_checkpoint=json.load(open(os.path.join(
                    p, "_delta_log", "_last_checkpoint"))))


def _dv_scenario(spark, F, D, root: str) -> dict:
    """Three files with deletion vectors enabled: a DELETE through
    vectors, a second that unions with them, one that deletes a whole
    file, one whose vector is too large to inline, then an UPDATE."""
    p = os.path.join(root, "dv")
    for i, lo in enumerate((0, 1000, 2000)):
        (spark.createDataFrame(_table(lo, 700, lo)).write.format("delta")
         .mode("error" if i == 0 else "append")
         .option("delta.enableDeletionVectors", "true").save(p))
    dt = D.DeltaTable.forPath(spark, p)
    reads = []
    for cond in (F.col("id") % 7 == 3, F.col("v") > 0.9,
                 F.col("id") >= 2000,
                 (F.col("id") < 1000) & (F.col("id") % 2 == 0)):
        dt.delete(cond)
        reads.append(_rows(spark.read.delta(p).collect_arrow()))
    snap = D.load_snapshot(p)
    dvmod = PDV if D is PD else JDV
    vectors = sorted(dvmod.load_descriptor(p, a["deletionVector"]).tolist()
                     for a in snap.files.values() if a.get("deletionVector"))
    dt.update(F.col("id") % 7 == 1, {"tag": "u"})
    reads.append(_rows(spark.read.delta(p).collect_arrow()))
    return dict(log=_log(p), reads=reads, vectors=vectors,
                sidecars=_sidecars(p), path=p)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs of both scenarios, once a module."""
    root = str(tmp_path_factory.mktemp("delta_ref"))
    spark = _jax()
    try:
        return dict(log=_log_scenario(spark, JF, JD, root),
                    dv=_dv_scenario(spark, JF, JD, root), root=root)
    finally:
        spark.stop()


@pytest.mark.parametrize("engine", ENGINES)
def test_log_dml_pruning_and_checkpoint_equal_reference(reference, engine,
                                                        tmp_path):
    spark = _port(engine)
    got = _log_scenario(spark, PF, PD, str(tmp_path))
    want = reference["log"]
    assert got["log"] == want["log"]
    # the DML pruned: DELETE and UPDATE rewrote one file of four each
    pruned = [json.loads(a)["commitInfo"]["prunedFiles"]
              for v in got["log"][4:8] for a in v if "commitInfo" in a]
    assert pruned == [3, 3, 3, 3]
    assert got["after_dml"].equals(want["after_dml"])
    assert got["final"].equals(want["final"])
    assert (got["version"], got["files"]) == (10, 3) == \
        (want["version"], want["files"])
    assert got["checkpoint"] == want["checkpoint"]
    assert got["last_checkpoint"] == want["last_checkpoint"]
    spark.stop()


@pytest.mark.parametrize("engine", ENGINES)
def test_deletion_vector_dml_equals_reference(reference, engine, tmp_path):
    spark = _port(engine)
    got = _dv_scenario(spark, PF, PD, str(tmp_path))
    want = reference["dv"]
    assert got["log"] == want["log"]
    for g, w in zip(got["reads"], want["reads"]):
        assert g.equals(w)
    assert got["vectors"] == want["vectors"]
    assert got["sidecars"] == want["sidecars"] and got["sidecars"]
    deletes = [[json.loads(a) for a in v] for v in got["log"][3:7]]
    # every DELETE wrote vectors and no data file: each add re-adds a file
    # with its vector; the whole-file one is a remove alone
    assert all("deletionVector" in a["add"]
               for v in deletes for a in v if "add" in a)
    assert [sum("add" in a for a in v) for v in deletes] == [3, 3, 0, 1]
    assert sum("remove" in a for a in deletes[2]) == 1
    # the UPDATE over the vectors resurrects no deleted row
    assert got["reads"][-1].num_rows == got["reads"][-2].num_rows
    spark.stop()


def test_column_mapping_read(tmp_path):
    """A column-mapping table (physical names in the files, logical ones
    in the schema): the port's read and a filter over it equal the
    reference's."""
    path = str(tmp_path / "mapped")
    os.makedirs(os.path.join(path, "_delta_log"))
    pq.write_table(pa.table({
        "col-9aab0d": pa.array([1, 2, 3], type=pa.int64()),
        "col-7ffe11": pa.array(["a", "b", "c"])}),
        os.path.join(path, "part-0.parquet"))
    fields = [{"name": n, "type": t, "nullable": True, "metadata": {
        "delta.columnMapping.id": i + 1,
        "delta.columnMapping.physicalName": ph}}
        for i, (n, t, ph) in enumerate((("id", "long", "col-9aab0d"),
                                        ("name", "string", "col-7ffe11")))]
    actions = [
        {"protocol": {"minReaderVersion": 2, "minWriterVersion": 5}},
        {"metaData": {"id": "m", "format": {"provider": "parquet",
                                            "options": {}},
                      "schemaString": json.dumps({"type": "struct",
                                                  "fields": fields}),
                      "partitionColumns": [],
                      "configuration": {"delta.columnMapping.mode": "name"},
                      "createdTime": 0}},
        {"add": {"path": "part-0.parquet", "partitionValues": {},
                 "size": 1, "modificationTime": 0, "dataChange": True}}]
    with open(PD._commit_file(path, 0), "w") as f:
        f.write("".join(json.dumps(a) + "\n" for a in actions))
    js = _jax()
    want = js.read.format("delta").load(path).filter(
        JF.col("id") > 1).collect_arrow()
    js.stop()
    for engine in ENGINES:
        spark = _port(engine)
        df = spark.read.format("delta").load(path)
        assert df.collect_arrow().to_pylist() == [
            {"id": 1, "name": "a"}, {"id": 2, "name": "b"},
            {"id": 3, "name": "c"}]
        assert df.filter(PF.col("id") > 1).collect_arrow().equals(want)
        spark.stop()


def test_empty_table_equals_reference(tmp_path):
    """An empty table reads as an empty relation with the log's schema;
    a DELETE over it commits nothing and a MERGE inserts into it."""
    empty = _table(0, 0, 0)
    src = _table(5, 4, 1)
    out = {}
    # the reference's fused engine fails on the empty relation's join
    # (jit_cache: one_fn() missing an argument); its adaptive engine runs
    ref = JaxSession({"spark.sql.shuffle.partitions": 2,
                      "spark.rapids.sql.fusedExec.enabled": False})
    for name, spark, F, D in (("ref", ref, JF, JD),
                              ("fused", _port("fused"), PF, PD),
                              ("aqe", _port("aqe"), PF, PD)):
        p = str(tmp_path / name)
        spark.createDataFrame(empty).write.format("delta").save(p)
        first = spark.read.delta(p).collect_arrow()
        dt = D.DeltaTable.forPath(spark, p)
        dt.delete(F.col("id") > 1)
        dt.merge(spark.createDataFrame(src), "id") \
            .whenNotMatchedInsertAll().execute()
        out[name] = (first, _log(p), _rows(spark.read.delta(p)
                                           .collect_arrow()))
        spark.stop()
    for name in ENGINES:
        assert out[name][0].num_rows == 0
        assert out[name][0].schema == out["ref"][0].schema
        assert out[name][1] == out["ref"][1]
        assert out[name][2].equals(out["ref"][2])


@pytest.mark.parametrize("case", ["array", "bitmap", "two_buckets", "empty"])
def test_dv_codec_bytes_equal_reference(case, tmp_path):
    """The DV codec: the blob, the inline descriptor and the sidecar
    file's bytes equal the reference's for the same indexes, and both
    parse each other's."""
    rng = np.random.default_rng(5)
    idx = {"array": rng.choice(60_000, 300, replace=False),
           "bitmap": np.arange(0, 20_000, 3),
           "two_buckets": np.array([1, 7, (1 << 32) + 5, (1 << 33) + 2]),
           "empty": np.zeros(0, np.int64)}[case].astype(np.int64)
    assert PDV.serialize_blob(idx) == JDV.serialize_blob(idx)
    assert PDV.inline_descriptor(idx) == JDV.inline_descriptor(idx)
    files = {}
    for name, mod in (("port", PDV), ("ref", JDV)):
        root = tmp_path / name
        root.mkdir()
        desc = mod.write_dv_file(str(root), {"f": idx})["f"]
        files[name] = (desc, _sidecars(str(root)))
        other = JDV if mod is PDV else PDV
        assert np.array_equal(other.load_descriptor(str(root), desc),
                              np.unique(idx))
    strip = {k: v for k, v in files["port"][0].items()
             if k != "pathOrInlineDv"}
    assert strip == {k: v for k, v in files["ref"][0].items()
                     if k != "pathOrInlineDv"}
    assert files["port"][1] == files["ref"][1]


def test_tables_read_across_packages(reference, tmp_path):
    """The reference's deletion-vector table read by the port, and the
    port's read by the reference, row for row."""
    js = _jax()
    ref_path = reference["dv"]["path"]
    want = reference["dv"]["reads"][-1]
    for engine in ENGINES:
        spark = _port(engine)
        assert _rows(spark.read.delta(ref_path).collect_arrow()).equals(want)
        spark.stop()
    spark = _port()
    p = str(tmp_path / "port_written")
    (spark.createDataFrame(_table(0, 500, 3)).write.format("delta")
     .option("delta.enableDeletionVectors", "true").save(p))
    PD.DeltaTable.forPath(spark, p).delete(PF.col("id") % 3 == 0)
    mine = _rows(spark.read.delta(p).collect_arrow())
    spark.stop()
    assert _rows(js.read.format("delta").load(p).collect_arrow()).equals(
        mine)
    assert mine.num_rows == 333
    js.stop()


def test_commit_conflict_retries_and_rewrite_conflict_raises(tmp_path,
                                                             monkeypatch):
    """A writer that loses its version to a concurrent commit retries one
    version later (counted); a rewrite whose files a concurrent commit
    removed raises DeltaConcurrentModification."""
    from spark_rapids_tpu_torch.io import commit as iocommit

    spark = _port()
    p = str(tmp_path / "occ")
    spark.createDataFrame(_table(0, 50, 0)).write.format("delta").save(p)
    real = PD._commit
    raced = []

    def racing_commit(table_path, version, actions, interval=None):
        if not raced:  # another writer claims this version first
            raced.append(version)
            real(table_path, version, [{"commitInfo": {
                "operation": "WRITE", "timestamp": 0}}], interval)
        return real(table_path, version, actions, interval)

    before = iocommit.write_totals()["conflicts"]
    monkeypatch.setattr(PD, "_commit", racing_commit)
    spark.createDataFrame(_table(50, 10, 1)).write.format("delta") \
        .mode("append").save(p)
    assert raced == [1]
    assert PD.load_snapshot(p).version == 2
    assert iocommit.write_totals()["conflicts"] == before + 1
    assert spark.read.delta(p).count() == 60

    raced.clear()

    def removing_commit(table_path, version, actions, interval=None):
        if not raced:  # a concurrent overwrite removes every file
            raced.append(version)
            snap = PD.load_snapshot(table_path)
            real(table_path, version, [{"remove": {
                "path": f, "deletionTimestamp": 0, "dataChange": True}}
                for f in snap.file_paths], interval)
        return real(table_path, version, actions, interval)

    monkeypatch.setattr(PD, "_commit", removing_commit)
    with pytest.raises(PD.DeltaConcurrentModification):
        PD.DeltaTable.forPath(spark, p).delete(PF.col("id") < 5)
    spark.stop()


@pytest.mark.parametrize("kind", ["arrow", "pandas", "dict", "rows"])
@pytest.mark.parametrize("engine", ENGINES)
def test_create_dataframe_inputs(kind, engine):
    """createDataFrame from each input kind equals the reference's, and a
    query over it runs on the session's engine."""
    t = _table(10, 40, 2).select(["id", "v", "tag"])
    data = {"arrow": t, "pandas": t.to_pandas(), "dict": t.to_pydict(),
            "rows": [tuple(r.values()) for r in t.to_pylist()]}[kind]
    schema = t.column_names if kind == "rows" else None
    js = _jax()
    want = js.createDataFrame(data, schema).collect_arrow()
    want_f = (js.createDataFrame(data, schema).filter(JF.col("id") > 20)
              .groupBy("tag").agg(JF.sum("v").alias("s"))
              .collect_arrow().sort_by("tag"))
    js.stop()
    spark = _port(engine)
    df = spark.createDataFrame(data, schema)
    got = df.collect_arrow()
    # pandas strings reach Arrow as large_string: the reference's host-only
    # plan keeps the type, the port's upload reads them back as string
    assert got.column_names == want.column_names
    assert got.to_pylist() == want.to_pylist()
    got_f = (df.filter(PF.col("id") > 20).groupBy("tag")
             .agg(PF.sum("v").alias("s")).collect_arrow().sort_by("tag"))
    assert got_f.column("tag").equals(want_f.column("tag"))
    np.testing.assert_allclose(got_f.column("s").to_numpy(),
                               want_f.column("s").to_numpy(), rtol=1e-12)
    with pytest.raises(TypeError):
        spark.createDataFrame([(1, 2)])
    spark.stop()


def test_refusals_name_their_roadmap_items(tmp_path):
    """What the slice leaves out raises, naming the ROADMAP item."""
    from spark_rapids_tpu_torch.lakehouse import read_iceberg

    spark = _port()
    df = spark.createDataFrame(_table(0, 5, 0))
    cases = [
        ("A9", lambda: spark.range(10)),
        ("A14", lambda: df.write.format("parquet").save(
            str(tmp_path / "pq"))),
        ("A14", lambda: df.write.format("csv").save(str(tmp_path / "c"))),
        ("A14", lambda: spark.read.format("csv").load(str(tmp_path))),
        ("A14", lambda: spark.read.format("iceberg").load(str(tmp_path))),
        ("A14", lambda: read_iceberg(spark, str(tmp_path))),
        ("A17", lambda: _port(**{"spark.rapids.tpu.chaos.enabled": True})),
    ]
    for item, run in cases:
        with pytest.raises(NotImplementedError, match=item):
            run()
    # partitioned Delta writes: the reference refuses them too
    with pytest.raises(NotImplementedError, match="partitioned"):
        df.write.format("delta").partitionBy("tag").save(
            str(tmp_path / "part"))
    spark.stop()
