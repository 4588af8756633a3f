"""The port's dataset catalog (ultra_torchdrug_tpu_torch/data/catalog.py)
against the JAX package's, on the CPU: every fixture of
tests/test_catalog_fixtures.py and tests/test_catalog_archives.py, written
under tmp_path in its real on-disk format and parsed by both packages, and
every registered name on a generated file set at its canonical cache
layout. Each split, the entity and relation counts, the vocabularies and
every graph's edge arrays must be equal (edge order feeds the CSR segments
and the tie conventions). The tar and zip flows go through each package's
``_download``, monkeypatched to copy a local archive; a guard makes
``urllib.request.urlretrieve`` raise, so nothing is fetched.
"""

import os
import shutil
import tarfile
import urllib.request
import zipfile

import numpy as np
import pytest

from ultra_torchdrug_tpu.data import catalog as j_catalog
from ultra_torchdrug_tpu.utils import config as j_config
from ultra_torchdrug_tpu_torch.data import catalog
from ultra_torchdrug_tpu_torch.data.datasets import JointDataset
from ultra_torchdrug_tpu_torch.utils import config

PACKAGES = {"port": (catalog, config.lookup),
            "jax": (j_catalog, j_config.lookup)}
GRAPHS = ("train_graph", "valid_graph", "test_graph", "graph",
          "inductive_graph")


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"a test tried to fetch {args[:1]}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def _write(path, rows, sep="\t"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(sep.join(row) + "\n")
    return path


def _assert_graph_equal(got, want, label):
    assert (got.num_nodes, got.num_relations) == (
        want.num_nodes, want.num_relations), label
    for field in ("edge_index", "edge_type", "edge_weight"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      f"{label}.{field}")


def assert_same_dataset(got, want):
    """Splits, counts, vocabularies and graphs equal; a JointDataset's
    parts each."""
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name
    kind = type(got).__name__  # either package's containers
    if kind == "JointDataset":
        assert len(got.datasets) == len(want.datasets)
        for a, b in zip(got.datasets, want.datasets):
            assert_same_dataset(a, b)
        return
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(got, split),
                                      getattr(want, split), split)
        assert getattr(got, split).dtype == getattr(want, split).dtype
    assert got.num_relations == want.num_relations
    if kind == "InductiveDataset":
        for name in GRAPHS:
            _assert_graph_equal(getattr(got, name), getattr(want, name), name)
        # which graphs are one object (valid on the train or the test graph)
        for a in GRAPHS:
            for b in GRAPHS:
                assert (getattr(got, a) is getattr(got, b)) == (
                    getattr(want, a) is getattr(want, b)), (a, b)
        return
    assert got.num_entities == want.num_entities
    _assert_graph_equal(got.graph, want.graph, "graph")
    assert hasattr(got, "vocab") == hasattr(want, "vocab")
    if hasattr(want, "vocab"):
        assert (got.vocab.ent, got.vocab.rel) == (want.vocab.ent,
                                                  want.vocab.rel)


def both(name, **kwargs):
    """(port dataset, JAX dataset) of registered ``name``."""
    return tuple(lookup(name)(**kwargs) for _, lookup in PACKAGES.values())


def test_registries_are_equal():
    assert config.registered_names() == j_config.registered_names()
    assert len(config.registered_names()) == 39


def test_vocab_and_load_file_match(tmp_path):
    """Column orders, TAB-only against any-whitespace splitting, short and
    blank lines, and grow=False dropping rows with unseen tokens."""
    path = _write(tmp_path / "f.txt", [
        ("New York", "in", "United States"), ("a", "r", "b"), ("x",),
        ("",), ("a b", "r2", "c d", "extra")])
    for order in ("hrt", "htr"):
        for sep in ("\t", None):
            got_v, want_v = catalog.Vocab(), j_catalog.Vocab()
            got = catalog._load_file(str(path), got_v, order, sep=sep)
            want = j_catalog._load_file(str(path), want_v, order, sep=sep)
            np.testing.assert_array_equal(got, want)
            assert (got_v.ent, got_v.rel) == (want_v.ent, want_v.rel)
            # a second file on the grown vocab, not growing it
            got = catalog._load_file(str(path), got_v, order, grow=False,
                                     sep=sep)
            want = j_catalog._load_file(str(path), want_v, order, grow=False,
                                        sep=sep)
            np.testing.assert_array_equal(got, want)
    empty = _write(tmp_path / "e.txt", [])
    assert catalog._load_file(str(empty), catalog.Vocab()).shape == (0, 3)


# ---------------------------------------------------------------------------
# the fixtures of tests/test_catalog_fixtures.py
# ---------------------------------------------------------------------------


def _codex(root):
    r = root / "codex-s"
    _write(r / "train.txt", [("a", "r0", "b"), ("b", "r1", "c")])
    _write(r / "valid.txt", [("a", "r0", "c")])
    _write(r / "test.txt", [("d", "r1", "a")])
    return "CoDExSmall", {}


def _codex_spaces(root):
    r = root / "codex-s"
    for s in ("train", "valid", "test"):
        _write(r / f"{s}.txt", [("New York", "in", "United States")])
    return "CoDExSmall", {}


def _dbpedia50k(root):
    rows = [("a", "b", "likes"), ("b", "c", "knows")]
    for s in ("train", "valid", "test"):
        _write(root / f"dbp50k_{s}.txt", rows[: 1 if s != "train" else 2])
    return "DBpedia50k", {}


def _sparser(root):
    r = root / "WD-singer"
    _write(r / "train.triples", [("s1", "s2", "sang"), ("s2", "s3", "wrote")])
    _write(r / "dev.triples", [("s1", "s3", "sang")])
    _write(r / "test.triples", [("s3", "s1", "wrote")])
    return "WDsinger", {}


def _nell995(root):
    _write(root / "nell995_facts.txt", [("a", "r0", "b"), ("b", "r0", "c")])
    _write(root / "nell995_train.txt", [("c", "r1", "a")])
    _write(root / "nell995_valid.txt", [("a", "r1", "c")])
    _write(root / "nell995_test.txt", [("b", "r1", "a")])
    return "NELL995", {}


def _urbankg(root):
    r = root / "UrbanKG_NYC"
    _write(r / "train_NYC.txt", [("poi1", "near", "poi2")])
    _write(r / "valid_NYC.txt", [("poi2", "near", "poi1")])
    _write(r / "test_NYC.txt", [("poi1", "near", "poi2")])
    return "UUKG_NYC", {}


def _ilpc(root):
    r = root / "ilpc-small" / "pykeen-ilpc2022-c5ea003" / "data" / "small"
    _write(r / "train.txt", [("a", "r0", "b"), ("b", "r1", "c")], sep=" ")
    _write(r / "inference.txt", [("p", "r0", "q"), ("q", "r1", "s")], sep=" ")
    _write(r / "inference_validation.txt", [("p", "r1", "s")], sep=" ")
    _write(r / "inference_test.txt", [("s", "r0", "p")], sep=" ")
    return "ILPC2022SmallInductive", {}


def _ingram(root):
    r = root / "fb-25"
    _write(r / "fb-25_train.txt", [("a", "r0", "b")], sep=" ")
    _write(r / "fb-25_msg.txt", [("m", "r0", "n")], sep=" ")
    _write(r / "fb-25_valid.txt", [("m", "r0", "o")], sep=" ")
    _write(r / "fb-25_test.txt", [("o", "r0", "n")], sep=" ")
    return "FBIngram", {}


def _mtdea(root):
    r = root / "Metafam"
    _write(r / "Metafam-trans/train.txt",
           [("a", "r0", "b"), ("b", "r1", "c")], sep=" ")
    _write(r / "Metafam-trans/valid.txt",
           [("a", "r1", "c"), ("a", "r0", "UNSEEN"), ("a", "rNEW", "b")],
           sep=" ")
    _write(r / "Metafam-ind/observe.txt", [("x", "r0", "y")], sep=" ")
    _write(r / "Metafam-ind/test.txt", [("y", "r0", "zNEW")], sep=" ")
    return "Metafam", {}


def _wikitopics(root):
    r = root / "WikiTopics-MT1"
    _write(r / "wikidata_healthv1-trans/train.txt", [("a", "r0", "b")], sep=" ")
    _write(r / "wikidata_healthv1-trans/valid.txt", [("a", "r0", "b")], sep=" ")
    _write(r / "wikidata_healthv1-ind/observe.txt", [("x", "r0", "y")], sep=" ")
    _write(r / "wikidata_healthv1-ind/test.txt", [("x", "r0", "y")], sep=" ")
    return "WikiTopicsMT1", {"version": "health"}


def _hamaguchi(root):
    r = root / "bm-1k"
    _write(r / "bm-1k_train.txt", [("a", "r0", "b")], sep=" ")
    _write(r / "bm-1k_test-graph.txt", [("x", "r0", "y")], sep=" ")
    _write(r / "bm-1k_valid.txt", [("a", "r0", "NEWENT")], sep=" ")
    _write(r / "bm-1k_test-fact.txt", [("y", "r0", "x")], sep=" ")
    return "HamaguchiBM", {"version": "1k"}


def _joint(root):
    r = root / "codex-s"
    for s in ("train", "valid", "test"):
        _write(r / f"{s}.txt", [("a", "r0", "b")])
    _write(root / "nell995_facts.txt", [("a", "r0", "b")])
    _write(root / "nell995_train.txt", [("b", "r0", "a")])
    _write(root / "nell995_valid.txt", [("a", "r0", "b")])
    _write(root / "nell995_test.txt", [("b", "r0", "a")])
    return "JointDataset", {"graphs": ("CoDExSmall", "NELL995")}


FIXTURES = {f.__name__[1:]: f for f in (
    _codex, _codex_spaces, _dbpedia50k, _sparser, _nell995, _urbankg, _ilpc,
    _ingram, _mtdea, _wikitopics, _hamaguchi, _joint)}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_fixture_families_parse_as_jax(tmp_path, fixture):
    name, kwargs = FIXTURES[fixture](tmp_path)
    got, want = both(name, path=str(tmp_path), **kwargs)
    assert_same_dataset(got, want)


def _grail_fixture(root, version="v1"):
    t = [("A", "r0", "B"), ("B", "r1", "C"), ("C", "r0", "A"),
         ("A", "r1", "C"), ("B", "r0", "A")]
    i = [("X", "r0", "Y"), ("Y", "r1", "Z"), ("X", "r1", "Z"),
         ("Z", "r0", "X"), ("Z", "r1", "Y")]
    _write(root / f"fb15k237_{version}_train.txt", t[:3])
    _write(root / f"fb15k237_{version}_valid.txt", t[3:4])
    _write(root / f"fb15k237_{version}_test.txt", t[4:5])
    _write(root / f"fb15k237_{version}_ind_train.txt", i[:2])
    _write(root / f"fb15k237_{version}_ind_valid.txt", i[2:3])
    _write(root / f"fb15k237_{version}_ind_test.txt", i[3:5])


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("ind_valid", [True, False])
def test_grail_merge_combos_parse_as_jax(tmp_path, merge, ind_valid):
    _grail_fixture(tmp_path)
    got, want = (cat._grail_inductive(
        "FB15k237Inductive", "fb237_%s", "fb15k237", path=str(tmp_path),
        version="v1", merge_valid_test=merge, use_inductive_valid=ind_valid)
        for cat, _ in PACKAGES.values())
    assert_same_dataset(got, want)
    assert got.valid_graph is (got.test_graph if ind_valid
                               else got.train_graph)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_grail_rejects_unseen_inductive_relation(tmp_path, package):
    _grail_fixture(tmp_path)
    _write(tmp_path / "fb15k237_v1_ind_test.txt", [("X", "rNEW", "Y")])
    cat, _ = PACKAGES[package]
    with pytest.raises(ValueError, match="1 relations absent from the "
                       "transductive graph"):
        cat._grail_inductive("FB15k237Inductive", "fb237_%s", "fb15k237",
                             path=str(tmp_path), version="v1")


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_mtdea_unknown_version_raises(tmp_path, package):
    _wikitopics(tmp_path)
    with pytest.raises(AssertionError, match="unknown version nope"):
        PACKAGES[package][1]("WikiTopicsMT1")(path=str(tmp_path),
                                              version="nope")


def test_a_failed_download_raises_the_same_error(tmp_path):
    """With no file at its cache path a loader downloads it; the guard's
    refusal surfaces as the same RuntimeError in both packages."""
    messages = []
    for cat, lookup in PACKAGES.values():
        with pytest.raises(RuntimeError, match="Pre-populate the dataset "
                           "cache directory") as info:
            lookup("FB15k237")(path=str(tmp_path / "empty"))
        messages.append(str(info.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# the archive flows of tests/test_catalog_archives.py
# ---------------------------------------------------------------------------


def _rows(*triples):
    return "".join("\t".join(t) + "\n" for t in triples)


def _serve(archive_path, requested=None):
    """A _download that copies the local archive, whatever the URL."""

    def download(url, dst):
        assert url.startswith("http"), url
        if requested is not None:
            requested.append(url)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if not os.path.exists(dst):
            shutil.copy(archive_path, dst)
        return dst

    return download


def _codex_tar(tmp_path):
    src = tmp_path / "src"
    os.makedirs(src)
    for split, rows in [("train", _rows(("a", "r0", "b"), ("b", "r1", "c"))),
                        ("valid", _rows(("a", "r0", "c"))),
                        ("test", _rows(("d", "r1", "a")))]:
        (src / f"{split}.txt").write_text(rows)
    tar_path = tmp_path / "codex-s.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        for split in ("train", "valid", "test"):
            tf.add(src / f"{split}.txt", arcname=f"codex-s/{split}.txt")
    return tar_path, "CoDExSmall"


def _ilpc_zip(tmp_path):
    zip_path = tmp_path / "ilpc.zip"
    member = "pykeen-ilpc2022-c5ea003/data/small/{f}.txt"
    contents = {
        "train": _rows(("a", "r0", "b"), ("b", "r1", "c"), ("c", "r0", "a")),
        "inference": _rows(("x", "r0", "y"), ("y", "r1", "z")),
        "inference_validation": _rows(("x", "r0", "z")),
        "inference_test": _rows(("z", "r1", "x")),
    }
    with zipfile.ZipFile(zip_path, "w") as zf:
        for f, data in contents.items():
            zf.writestr(member.format(f=f), data)
    return zip_path, "ILPC2022SmallInductive"


def _aristo_zip(tmp_path):
    zip_path = tmp_path / "aristo.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        zf.writestr("train", _rows(("a", "r0", "b"), ("c", "r1", "a")))
        zf.writestr("valid", _rows(("b", "r0", "c")))
        zf.writestr("test", _rows(("a", "r1", "c")))
    return zip_path, "AristoV4"


@pytest.mark.parametrize("archive", [_codex_tar, _ilpc_zip, _aristo_zip],
                         ids=["codex-tar", "ilpc-zip", "aristo-zip"])
def test_archive_flows_parse_as_jax(tmp_path, monkeypatch, archive):
    """Each package downloads (a copy of) the archive into a cache of its
    own, extracts the reference's member layout and parses it; a second
    build reads the extracted files without downloading."""
    path, name = archive(tmp_path)
    got = []
    for key, (cat, lookup) in PACKAGES.items():
        requested = []
        cache = tmp_path / f"cache-{key}"
        monkeypatch.setattr(cat, "_download", _serve(str(path), requested))
        got.append(lookup(name)(path=str(cache)))
        assert requested, key
        monkeypatch.setattr(cat, "_download",
                            lambda url, dst: pytest.fail("re-downloaded"))
        assert_same_dataset(lookup(name)(path=str(cache)), got[-1])
    assert_same_dataset(*got)


def test_grail_download_flow_urls(tmp_path, monkeypatch):
    """GraIL's six per-split files: the same URLs, in the same order, land
    on the same cache names in both packages."""
    requests = {}
    got = []
    for key, (cat, lookup) in PACKAGES.items():
        requested = requests.setdefault(key, [])

        def fake_download(url, dst, requested=requested):
            requested.append((url, os.path.basename(dst)))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            rows = (_rows(("u1", "r0", "u2"), ("u2", "r1", "u3"))
                    if "_ind" in url else
                    _rows(("e1", "r0", "e2"), ("e2", "r1", "e3")))
            with open(dst, "w") as f:
                f.write(rows)
            return dst

        monkeypatch.setattr(cat, "_download", fake_download)
        got.append(lookup("FB15k237Inductive")(
            path=str(tmp_path / key), version="v2"))
    assert requests["port"] == requests["jax"]
    assert len(requests["port"]) == 6
    assert_same_dataset(*got)


# ---------------------------------------------------------------------------
# every registered name on a generated file set at its canonical layout
# ---------------------------------------------------------------------------


def _generated_rows(seed, n, prefix, htr=False):
    rng = np.random.default_rng(seed)
    rows = []
    for h, t, r in zip(rng.integers(0, 12, n), rng.integers(0, 12, n),
                       rng.integers(0, 4, n)):
        h, t, r = f"{prefix} {h}", f"{prefix}:{t}", f"/rel/{r}"
        rows.append((h, t, r) if htr else (h, r, t))
    return rows


def _tsv(root, files, htr=False, prefix="e", n=(40, 8, 8)):
    for seed, (f, k) in enumerate(zip(files, n)):
        _write(root / f, _generated_rows(seed, k, prefix, htr))


def _four(root, files):
    """train, inference, valid, test; whitespace-separated, so no token may
    hold a space."""
    for seed, (f, prefix, k) in enumerate(zip(
            files, ("e", "i", "e", "i"), (40, 40, 8, 8))):
        rows = [tuple(tok.replace(" ", "_") for tok in row)
                for row in _generated_rows(seed, k, prefix)]
        _write(root / f, rows, sep=" ")


def _split_files(fmt):
    return [fmt.format(s=s) for s in ("train", "valid", "test")]


def layout(name, root):
    """Write ``name``'s files at its canonical cache layout under root;
    returns the loader's keyword arguments."""
    if name.startswith("CoDEx"):
        size = {"CoDExSmall": "s", "CoDExMedium": "m", "CoDExLarge": "l"}[name]
        _tsv(root, _split_files(f"codex-{size}/{{s}}.txt"))
    elif name == "ConceptNet100k":
        _tsv(root, _split_files("cn100k_{s}"))
    elif name == "DBpedia50k":
        _tsv(root, _split_files("dbp50k_{s}.txt"), htr=True)
    elif name == "DBpedia100k":
        _tsv(root, _split_files("dbp100k_{s}.txt"))
    elif name in ("FB15k237", "WN18RR", "YAGO310"):
        _tsv(root, _split_files(f"{name.lower()}_{{s}}.txt"))
    elif name == "AristoV4":
        _tsv(root, ["train", "valid", "test"])
    elif name == "ATOMIC":
        _tsv(root, _split_files("Atomic/{s}"))
    elif name == "NELL995":
        _tsv(root, [f"nell995_{s}.txt"
                    for s in ("facts", "train", "valid", "test")],
             n=(30, 10, 8, 8))
    elif name in ("WDsinger", "NELL23k", "FB15k237_10", "FB15k237_20",
                  "FB15k237_50"):
        folder = {"WDsinger": "WD-singer", "NELL23k": "NELL23K"}.get(
            name, name.replace("FB15k237", "FB15K-237").replace("_", "-"))
        _tsv(root, [f"{folder}/{s}.triples" for s in ("train", "dev",
                                                      "test")], htr=True)
    elif name.startswith("UUKG_"):
        city = name[5:]
        _tsv(root, _split_files(f"UrbanKG_{city}/{{s}}_{city}.txt"))
    elif name.endswith("Inductive") and not name.startswith("ILPC"):
        prefix = {"FB15k237Inductive": "fb15k237",
                  "WN18RRInductive": "wn18rr",
                  "NELLInductive": "nell"}[name]
        _tsv(root, _split_files(f"{prefix}_v3_{{s}}.txt"))
        _tsv(root, _split_files(f"{prefix}_v3_ind_{{s}}.txt"), prefix="i")
        return {"version": "v3", "merge_valid_test": False,
                "use_inductive_valid": True}
    elif name.startswith("ILPC"):
        size = "small" if "Small" in name else "large"
        base = f"ilpc-{size}/pykeen-ilpc2022-c5ea003/data/{size}/"
        _four(root, [base + f + ".txt" for f in (
            "train", "inference", "inference_validation", "inference_test")])
    elif name.endswith("Ingram"):
        p = name[:2].lower()
        _four(root, [f"{p}-25/{p}-25_{f}.txt"
                     for f in ("train", "msg", "valid", "test")])
    elif name in ("FBNELL", "Metafam") or name.startswith("WikiTopics"):
        folder, prefix, version = {
            "FBNELL": ("FBNELL", "FBNELL_v1", None),
            "Metafam": ("Metafam", "Metafam", None),
            "WikiTopicsMT1": ("WikiTopics-MT1", "wikidata_mtv1", "mt"),
            "WikiTopicsMT2": ("WikiTopics-MT2", "wikidata_orgv1", "org"),
            "WikiTopicsMT3": ("WikiTopics-MT3", "wikidata_infrav2", "infra"),
            "WikiTopicsMT4": ("WikiTopics-MT4", "wikidata_healthv2",
                              "health"),
        }[name]
        _four(root, [f"{folder}/{prefix}-trans/train.txt",
                     f"{folder}/{prefix}-ind/observe.txt",
                     f"{folder}/{prefix}-trans/valid.txt",
                     f"{folder}/{prefix}-ind/test.txt"])
        return {"version": version} if version else {}
    elif name == "HamaguchiBM":
        _four(root, [f"bm-3k/bm-3k_{f}.txt" for f in (
            "train", "test-graph", "valid", "test-fact")])
        return {"version": "3k"}
    elif name == "JointDataset":
        for part in ("FB15k237", "WN18RR", "CoDExMedium"):
            layout(part, root)
        return {"graphs": ["FB15k237", "WN18RR", "CoDExMedium"]}
    elif name.startswith("Synth"):
        return {}
    else:
        raise KeyError(name)
    return {}


@pytest.mark.parametrize("name", config.registered_names())
def test_every_registered_name_parses_as_jax(tmp_path, name):
    kwargs = layout(name, tmp_path)
    got, want = both(name, path=str(tmp_path), **kwargs)
    assert_same_dataset(got, want)
    parts = got.datasets if isinstance(got, JointDataset) else [got]
    for part in parts:
        assert len(part.train) and len(part.test)
