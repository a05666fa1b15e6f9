"""The port's nine ingestion CLIs against the JAX package's scripts on the
CPU: ``--help`` of each (the same options, the same defaults), then one
real run of each of the eight stage CLIs in this process (JAX's ``main``
with ``sys.argv`` patched, the port's ``main(argv)``) along the chain on a
raw tree of ``tests/conftest.py``'s frames (three stratification classes
of 20, 20 and 10 frames, so the split completes), each stage reading the
same input: the same files
(parquets with the resized-image root substituted, the rest byte-equal,
symlinks to the same targets). ``build_synth_corpus``'s run is the chain
test's (``tests/test_torch_ingest_chain.py``). The two analysis CLIs also
run where matplotlib cannot be imported (they print that they skipped the
plot) and the QA CLI on a corrupted index (exit 1, the same report)."""

import builtins
import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from conftest import _make_frame

REPO = Path(__file__).resolve().parents[1]
CLIS = {"build_zod_index": "build_ZOD_index", "add_bboxes": "add_bboxes",
        "add_solar_context_bins": "add_solar_context_bins", "create_splits": "create_splits",
        "export_yolo_dataset": "export_yolo_dataset",
        "export_coco_dataset": "export_coco_dataset", "analyze_index_qa": "analyze_index_qa",
        "analyze_context_frequencies": "analyze_context_frequencies",
        "build_synth_corpus": "build_synth_corpus"}
# (frames, clear pedestrians, unclear, time of day, solar elevation)
TREE_CLASSES = ((20, 1, 1, "day", 30.0), (20, 3, 0, "night", -12.0), (10, 0, 2, "day", None))
TREE_FRAMES = sum(c[0] for c in TREE_CLASSES)


def port_cli(name: str):
    return importlib.import_module(f"multimodal_moe_torch.cli.{name}")


def jax_script(name: str):
    """``scripts/<name>.py`` as a module (its ``_common`` import needs
    ``scripts/`` on the path; ``MMOE_XLA_CACHE=''`` keeps JAX's compile
    cache off)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                      REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.fixture(autouse=True)
def no_xla_cache(monkeypatch):
    monkeypatch.setenv("MMOE_XLA_CACHE", "")


def run_jax(name: str, args: list, monkeypatch) -> "tuple[object, str]":
    module = jax_script(CLIS[name])
    monkeypatch.setattr(sys, "argv", [f"{CLIS[name]}.py", *map(str, args)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main()
    return rc, out.getvalue()


def run_port(name: str, args: list) -> "tuple[object, str]":
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli(name).main([str(a) for a in args])
    return rc, out.getvalue()


def help_text(run) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        run()
    assert e.value.code == 0
    return out.getvalue()


@pytest.mark.parametrize("name", sorted(CLIS))
def test_help_and_defaults_match(name, monkeypatch):
    module = jax_script(CLIS[name])
    monkeypatch.setattr(sys, "argv", [f"{CLIS[name]}.py", "--help"])
    ref = help_text(module.main)
    got = help_text(lambda: port_cli(name).main(["--help"]))
    options = lambda text: sorted(set(re.findall(r"--[a-z][a-z0-9-]*", text)))  # noqa: E731
    assert options(got) == options(ref) and options(ref)
    if name == "analyze_index_qa":        # JAX's script parses inside main()
        return
    monkeypatch.setattr(sys, "argv", [f"{CLIS[name]}.py"])
    want = vars(module.parse_args())
    have = vars(port_cli(name).parse_args([]))
    if name == "build_synth_corpus":      # a root in the home directory, as JAX's
        assert Path(have.pop("root")).name == Path(want.pop("root")).name == "synthzod"
    assert have == want


def files(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_symlink():
            out[str(p.relative_to(root))] = ("link", str(p.readlink()))
        elif p.is_file():
            out[str(p.relative_to(root))] = p.read_bytes()
    return out


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_raw")
    rng = np.random.default_rng(8)
    i = 0
    for count, clear, unclear, tod, solar in TREE_CLASSES:
        for _ in range(count):
            i += 1
            _make_frame(root, f"{i:06d}", rng=rng, n_clear=clear, n_unclear=unclear,
                        time_of_day=tod, solar_elevation=solar)
    return root


def test_stage_clis_write_jax_files(raw_tree, tmp_path, monkeypatch):
    port, ref = tmp_path / "port", tmp_path / "jax"

    def both(name, make_args):
        got = run_port(name, make_args(port))
        want = run_jax(name, make_args(ref), monkeypatch)
        assert got[0] == want[0], name
        return got, want

    # build_zod_index: the resized images and the index.
    both("build_zod_index", lambda d: ["--zod-root", raw_tree, "--out-parquet", d / "idx.parquet",
                                       "--resized-img-root", d / "resized", "--workers", 2])
    assert files(port / "resized") == files(ref / "resized")
    assert len(files(ref / "resized")) == TREE_FRAMES
    idx = pd.read_parquet(ref / "idx.parquet")
    got = pd.read_parquet(port / "idx.parquet")
    got["resized_image_path"] = got["resized_image_path"].str.replace(str(port), str(ref))
    pd.testing.assert_frame_equal(got, idx)

    # Every later stage reads JAX's output of the stage before.
    src = ref / "idx.parquet"
    both("add_bboxes", lambda d: ["--in-parquet", src, "--out-parquet", d / "boxes.parquet"])
    assert (port / "boxes.parquet").read_bytes() == (ref / "boxes.parquet").read_bytes()
    src = ref / "boxes.parquet"
    both("add_solar_context_bins",
         lambda d: ["--in-parquet", src, "--out-parquet", d / "final.parquet"])
    assert (port / "final.parquet").read_bytes() == (ref / "final.parquet").read_bytes()
    for mod in ("port", "jax"):                  # an existing output needs --overwrite
        with pytest.raises(FileExistsError):
            (run_port if mod == "port" else lambda n, a: run_jax(n, a, monkeypatch))(
                "add_solar_context_bins",
                ["--in-parquet", src, "--out-parquet", ref / "final.parquet"])
    final = ref / "final.parquet"
    both("create_splits", lambda d: ["--parquet", final, "--output-dir", d / "splits"])
    assert files(port / "splits") == files(ref / "splits")
    splits = ref / "splits"
    for policy in ("exclude_unclear", "keep_all"):
        both("export_yolo_dataset", lambda d: ["--parquet", final, "--splits-dir", splits,
                                               "--out-dir", d / f"yolo_{policy}",
                                               "--unclear-policy", policy])
        got, want = files(port / f"yolo_{policy}"), files(ref / f"yolo_{policy}")
        yaml = "dataset.yaml"
        assert got.pop(yaml) == want.pop(yaml).replace(str(ref).encode(), str(port).encode())
        assert got == want and sum(k.startswith("labels/") for k in want) == TREE_FRAMES
    both("export_coco_dataset", lambda d: ["--parquet", final, "--splits-dir", splits,
                                           "--out-dir", d / "coco", "--splits", "val", "test",
                                           "--max-frames-per-split", 3])
    got, want = files(port / "coco"), files(ref / "coco")
    assert list(got) == list(want)
    for rel in want:
        if rel.endswith(".json"):
            assert json.loads(got[rel].decode().replace(str(port), str(ref))) == \
                json.loads(want[rel]), rel
        else:
            assert got[rel] == want[rel], rel
    assert len(json.loads(want["annotations/instances_val.json"])["images"]) == 3

    # The analysis CLIs, with their plots.
    got, want = both("analyze_index_qa", lambda d: ["--parquet", final, "--out-dir", d / "qa",
                                                    "--plots"])
    assert got[0] == want[0] == 0
    assert set(files(port / "qa")) == set(files(ref / "qa")) == \
        {"qa_report.json", "qa_report.md", "qa_histograms.png"}
    for rel in ("qa_report.json", "qa_report.md"):
        assert (port / "qa" / rel).read_bytes() == (ref / "qa" / rel).read_bytes(), rel
    both("analyze_context_frequencies", lambda d: ["--parquet", final, "--out-dir", d / "ctx"])
    rel = "context_field_frequencies.csv"
    assert (port / "ctx" / rel).read_bytes() == (ref / "ctx" / rel).read_bytes()
    assert set(files(port / "ctx")) == set(files(ref / "ctx")) == \
        {rel, "context_field_frequencies.png"}


def test_analysis_clis_without_matplotlib_and_on_a_bad_index(raw_tree, tmp_path, monkeypatch):
    from multimodal_moe_torch.data import indexer, solar

    cfg = indexer.IndexConfig(zod_root=raw_tree, out_parquet=tmp_path / "idx.parquet",
                              max_frames=6)
    df = solar.add_solar_context_bins(indexer.add_xyxy_bboxes(indexer.build_index(cfg)))
    df.to_parquet(tmp_path / "ok.parquet")
    i = int(df.index[(df.ped_count_clear + df.ped_count_unclear) > 0][0])
    df.at[i, "ped_uuid"] = list(df.at[i, "ped_uuid"])[:-1]
    df.to_parquet(tmp_path / "bad.parquet")

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(builtins, "__import__", no_matplotlib)
        rc, out = run_port("analyze_index_qa", ["--parquet", tmp_path / "ok.parquet",
                                                "--out-dir", tmp_path / "qa", "--plots"])
        assert rc == 0 and "skipped plot" in out
        rc, out = run_port("analyze_context_frequencies", ["--parquet", tmp_path / "ok.parquet",
                                                           "--out-dir", tmp_path / "ctx"])
        assert "skipped plot" in out
    assert sorted(p.name for p in (tmp_path / "qa").iterdir()) == ["qa_report.json",
                                                                   "qa_report.md"]
    assert sorted(p.name for p in (tmp_path / "ctx").iterdir()) == [
        "context_field_frequencies.csv"]

    for name, run in (("port", run_port),
                      ("jax", lambda n, a: run_jax(n, a, monkeypatch))):
        rc, _ = run("analyze_index_qa", ["--parquet", tmp_path / "bad.parquet",
                                         "--out-dir", tmp_path / f"bad_{name}"])
        assert rc == 1
    for rel in ("qa_report.json", "qa_report.md"):
        assert (tmp_path / "bad_port" / rel).read_bytes() == \
            (tmp_path / "bad_jax" / rel).read_bytes()
