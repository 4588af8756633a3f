"""Dataset catalog (counterpart of ultra_torchdrug_tpu/data/catalog.py):
downloaders and parsers for every dataset family of the reference, producing
the Transductive, Inductive and Joint containers of data/datasets.py.

Families and their file semantics:
  * CoDEx S/M/L: per-split h r t files, one vocabulary
  * tsv transductive (ConceptNet100k, ATOMIC, AristoV4, NELL995 with its
    facts merged into train, UrbanKG, FB15k237, WN18RR, YAGO310): h r t
  * DBpedia50k and the sparser KGs (WDsinger, NELL23k, FB15k237_10/20/50):
    h t r column order
  * GraIL inductives FB15k237/WN18RR/NELL v1-v4: six files, with the
    merge_valid_test x use_inductive_valid combinations
  * ILPC 2022 S/L: train and inference graphs with vocabularies of their own
  * InGram FB/WK/NL: train/msg/valid/test, msg the inference graph
  * MTDEA (FBNELL, Metafam, WikiTopics MT1-4): local dumps, valid on the
    train vocabulary (rows with unseen tokens dropped), test on the
    inference vocabulary
  * HamaguchiBM: INDIGO-style four files
  * JointDataset: a list of transductive sets for pre-training

Vocabularies are built in file order, so ids (and with them the graphs'
edge arrays) are the JAX package's. Every loader reads pre-populated files
at its canonical cache path under ``path`` first; only a missing file is
downloaded, through urllib, and a failed download raises with the path to
pre-populate.
"""

from __future__ import annotations

import os
import urllib.request
import zipfile
from functools import partial
from typing import Dict, List, Optional

import numpy as np

from ..utils.config import register
from .datasets import (
    InductiveDataset,
    JointDataset,
    TransductiveDataset,
    synthetic_compositional,
    synthetic_inductive,
    synthetic_transductive,
)
from .graph import Graph


# ---------------------------------------------------------------------------
# IO helpers
# ---------------------------------------------------------------------------


def _download(url: str, dst: str):
    if os.path.exists(dst):
        return dst
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    try:
        urllib.request.urlretrieve(url, dst)
    except Exception as e:  # zero-egress environments land here
        raise RuntimeError(
            f"cannot download {url} -> {dst}: {e}. Pre-populate the dataset "
            f"cache directory with the expected files to run offline."
        ) from e
    return dst


def _extract(zip_path: str, member: str, dst_dir: str) -> str:
    out = os.path.join(dst_dir, member)
    if not os.path.exists(out):
        with zipfile.ZipFile(zip_path) as zf:
            zf.extract(member, dst_dir)
    return out


class Vocab:
    def __init__(self):
        self.ent: Dict[str, int] = {}
        self.rel: Dict[str, int] = {}

    def entity(self, tok: str, grow=True) -> Optional[int]:
        if tok not in self.ent:
            if not grow:
                return None
            self.ent[tok] = len(self.ent)
        return self.ent[tok]

    def relation(self, tok: str, grow=True) -> Optional[int]:
        if tok not in self.rel:
            if not grow:
                return None
            self.rel[tok] = len(self.rel)
        return self.rel[tok]


def _load_file(
    path: str, vocab: Vocab, order: str = "hrt", grow: bool = True,
    sep: Optional[str] = "\t",
) -> np.ndarray:
    """Parse one triple file into [N, 3] (h, t, r) int32 rows.

    order: column order in the file — "hrt" (most datasets) or "htr"
    (DBpedia50k/SparserKG). grow=False drops rows with unseen tokens
    (MTDEA limit_vocab semantics). sep: "\\t" for the tsv families (the
    reference uses csv.reader(delimiter="\\t"), so entity names may contain
    spaces — dataset.py:345, :1149); None = any-whitespace split (the
    ILPC/InGram/MTDEA/BM load_file families use line.split(), :259, :795)."""
    triples = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            tokens = line.rstrip("\r\n").split(sep)
            if not tokens or len(tokens) < 3:
                continue
            if order == "hrt":
                h_tok, r_tok, t_tok = tokens[:3]
            else:
                h_tok, t_tok, r_tok = tokens[:3]
            h = vocab.entity(h_tok, grow)
            t = vocab.entity(t_tok, grow)
            r = vocab.relation(r_tok, grow)
            if h is None or t is None or r is None:
                continue
            triples.append((h, t, r))
    if not triples:
        return np.zeros((0, 3), np.int32)
    return np.asarray(triples, np.int32)


def _transductive_from_files(
    name: str, files: List[str], order: str = "hrt"
) -> TransductiveDataset:
    vocab = Vocab()
    splits = [_load_file(f, vocab, order) for f in files]
    train, valid, test = splits[0], splits[1], splits[2]
    all_triples = np.concatenate([train, valid, test], axis=0)
    graph = Graph.from_triplets(all_triples, len(vocab.ent), len(vocab.rel))
    ds = TransductiveDataset(name, graph, train, valid, test)
    ds.vocab = vocab
    return ds


_DEFAULT_PATH = "~/kg-datasets"


def _cache(path: str, *parts: str) -> str:
    return os.path.join(os.path.expanduser(path or _DEFAULT_PATH), *parts)


# ---------------------------------------------------------------------------
# transductive: CoDEx + simple tsv families
# ---------------------------------------------------------------------------

_CODEX_URL = "https://zenodo.org/record/4281094/files/codex-{s}.tar.gz"


def _codex(size: str, path: str = _DEFAULT_PATH, **_) -> TransductiveDataset:
    root = _cache(path, f"codex-{size}")
    # either pre-populated flat files or a previously extracted tarball
    # (members are codex-{size}/{split}.txt, reference dataset.py:37-39)
    for base in (root, os.path.join(root, f"codex-{size}")):
        files = [os.path.join(base, f"{s}.txt") for s in ("train", "valid", "test")]
        if all(os.path.exists(f) for f in files):
            return _transductive_from_files(f"CoDEx{size.upper()}", files, "hrt")
    import tarfile

    tar = _download(_CODEX_URL.format(s=size), os.path.join(root, f"codex-{size}.tar.gz"))
    with tarfile.open(tar) as tf:
        # filter='data' rejects path-traversal members (../, absolute paths)
        # and is the non-deprecated spelling on 3.12+
        tf.extractall(root, filter="data")
    inner = os.path.join(root, f"codex-{size}")
    base = inner if os.path.isdir(inner) else root
    files = [os.path.join(base, f"{s}.txt") for s in ("train", "valid", "test")]
    return _transductive_from_files(f"CoDEx{size.upper()}", files, "hrt")


register("CoDExSmall")(partial(_codex, "s"))
register("CoDExMedium")(partial(_codex, "m"))
register("CoDExLarge")(partial(_codex, "l"))


def _simple_transductive(name, urls, save_prefix, order="hrt"):
    def build(path: str = _DEFAULT_PATH, **_) -> TransductiveDataset:
        files = []
        for url in urls:
            dst = _cache(path, f"{save_prefix}{os.path.basename(url)}")
            if not os.path.exists(dst):
                _download(url, dst)
            files.append(dst)
        return _transductive_from_files(name, files, order)

    return register(name)(build)


_simple_transductive(
    "ConceptNet100k",
    [
        "https://raw.githubusercontent.com/guojiapub/BiQUE/master/src_data/conceptnet-100k/train",
        "https://raw.githubusercontent.com/guojiapub/BiQUE/master/src_data/conceptnet-100k/valid",
        "https://raw.githubusercontent.com/guojiapub/BiQUE/master/src_data/conceptnet-100k/test",
    ],
    "cn100k_",
)
_simple_transductive(
    "DBpedia50k",
    [
        "https://raw.githubusercontent.com/ZhenfengLei/KGDatasets/master/DBpedia50/train.txt",
        "https://raw.githubusercontent.com/ZhenfengLei/KGDatasets/master/DBpedia50/valid.txt",
        "https://raw.githubusercontent.com/ZhenfengLei/KGDatasets/master/DBpedia50/test.txt",
    ],
    "dbp50k_",
    order="htr",
)
_simple_transductive(
    "DBpedia100k",
    [
        "https://raw.githubusercontent.com/iieir-km/ComplEx-NNE_AER/master/datasets/DB100K/_train.txt",
        "https://raw.githubusercontent.com/iieir-km/ComplEx-NNE_AER/master/datasets/DB100K/_valid.txt",
        "https://raw.githubusercontent.com/iieir-km/ComplEx-NNE_AER/master/datasets/DB100K/_test.txt",
    ],
    "dbp100k",
)
# standard FB15k237 / WN18RR / YAGO310 mirrors (train/valid/test, h r t)
_KGE_MIRROR = "https://raw.githubusercontent.com/villmow/datasets_knowledge_embedding/master/{d}/{s}.txt"
for _name, _dir in [("FB15k237", "FB15k-237"), ("WN18RR", "WN18RR"), ("YAGO310", "YAGO3-10")]:
    _simple_transductive(
        _name,
        [_KGE_MIRROR.format(d=_dir, s=s) for s in ("train", "valid", "test")],
        f"{_name.lower()}_",
    )


@register("AristoV4")
def _aristo(path: str = _DEFAULT_PATH, **_) -> TransductiveDataset:
    root = _cache(path)
    files = [os.path.join(root, s) for s in ("train", "valid", "test")]
    if not all(os.path.exists(f) for f in files):
        zip_path = _download(
            "https://zenodo.org/record/5942560/files/aristo-v4.zip",
            os.path.join(root, "aristo-v4.zip"),
        )
        files = [_extract(zip_path, s, root) for s in ("train", "valid", "test")]
    return _transductive_from_files("AristoV4", files, "hrt")


@register("ATOMIC")
def _atomic(path: str = _DEFAULT_PATH, **_) -> TransductiveDataset:
    root = _cache(path, "Atomic")  # manual download (google drive), ref :616-621
    files = [os.path.join(root, s) for s in ("train", "valid", "test")]
    return _transductive_from_files("ATOMIC", files, "hrt")


@register("NELL995")
def _nell995(path: str = _DEFAULT_PATH, **_) -> TransductiveDataset:
    base = "https://raw.githubusercontent.com/LARS-research/RED-GNN/main/transductive/data/nell/"
    files = []
    for s in ("facts.txt", "train.txt", "valid.txt", "test.txt"):
        dst = _cache(path, f"nell995_{s}")
        if not os.path.exists(dst):
            _download(base + s, dst)
        files.append(dst)
    vocab = Vocab()
    facts, train, valid, test = (_load_file(f, vocab, "hrt") for f in files)
    train = np.concatenate([facts, train], axis=0)  # facts+train merge (:1306)
    graph = Graph.from_triplets(
        np.concatenate([train, valid, test], 0), len(vocab.ent), len(vocab.rel)
    )
    return TransductiveDataset("NELL995", graph, train, valid, test)


def _sparser_kg(name, folder):
    @register(name)
    def build(path: str = _DEFAULT_PATH, **_) -> TransductiveDataset:
        root = _cache(path, folder)  # local dumps (DacKGR), ref :1233-1246
        files = [
            os.path.join(root, f"{s}.triples") for s in ("train", "dev", "test")
        ]
        return _transductive_from_files(name, files, "htr")

    return build


_sparser_kg("WDsinger", "WD-singer")
_sparser_kg("NELL23k", "NELL23K")
_sparser_kg("FB15k237_10", "FB15K-237-10")
_sparser_kg("FB15k237_20", "FB15K-237-20")
_sparser_kg("FB15k237_50", "FB15K-237-50")


def _urban_kg(name, suffix):
    @register(name)
    def build(path: str = _DEFAULT_PATH, **_) -> TransductiveDataset:
        root = _cache(path, f"UrbanKG_{suffix}")  # manual dumps, ref :1320-1337
        files = [
            os.path.join(root, f"{s}_{suffix}.txt")
            for s in ("train", "valid", "test")
        ]
        return _transductive_from_files(name, files, "hrt")

    return build


_urban_kg("UUKG_NYC", "NYC")
_urban_kg("UUKG_CHI", "CHI")


# ---------------------------------------------------------------------------
# inductive: GraIL six-file family
# ---------------------------------------------------------------------------

_GRAIL = "https://raw.githubusercontent.com/kkteru/grail/master/data/{d}/{s}.txt"


def _grail_inductive(
    name: str,
    grail_dir: str,
    save_prefix: str,
    path: str = _DEFAULT_PATH,
    version: str = "v1",
    merge_valid_test: bool = True,
    use_inductive_valid: bool = False,
    **_,
) -> InductiveDataset:
    trans_files, ind_files = [], []
    for s in ("train", "valid", "test"):
        dst = _cache(path, f"{save_prefix}_{version}_{s}.txt")
        if not os.path.exists(dst):
            _download(_GRAIL.format(d=grail_dir % version, s=s), dst)
        trans_files.append(dst)
    for s in ("train", "valid", "test"):
        dst = _cache(path, f"{save_prefix}_{version}_ind_{s}.txt")
        if not os.path.exists(dst):
            _download(_GRAIL.format(d=grail_dir % version + "_ind", s=s), dst)
        ind_files.append(dst)
    return _load_grail(
        f"{name}-{version}", trans_files, ind_files, merge_valid_test,
        use_inductive_valid,
    )


def _load_grail(
    name, trans_files, ind_files, merge_valid_test, use_inductive_valid
) -> InductiveDataset:
    """load_inductive_tsvs semantics (reference dataset.py:337-445)."""
    tv = Vocab()  # transductive vocab
    iv = Vocab()  # inductive vocab (relations shared with transductive)
    t_train = _load_file(trans_files[0], tv, "hrt")
    t_valid = _load_file(trans_files[1], tv, "hrt")
    t_test = _load_file(trans_files[2], tv, "hrt")
    R = len(tv.rel)
    iv.rel = tv.rel  # inductive relations must exist in the transductive vocab
    i_train = _load_file(ind_files[0], iv, "hrt")
    i_valid = _load_file(ind_files[1], iv, "hrt")
    i_test = _load_file(ind_files[2], iv, "hrt")
    if len(tv.rel) != R:  # reference asserts r in vocab (dataset.py:379)
        raise ValueError(
            f"inductive files introduced {len(tv.rel) - R} relations absent "
            f"from the transductive graph"
        )

    train_graph = Graph.from_triplets(t_train, len(tv.ent), R)
    test_graph = Graph.from_triplets(i_train, len(iv.ent), R)
    valid_graph = test_graph if use_inductive_valid else train_graph
    graph = Graph.from_triplets(
        np.concatenate([t_train, t_valid, t_test], 0), len(tv.ent), R
    )
    inductive_graph = Graph.from_triplets(
        np.concatenate([i_train, i_valid, i_test], 0), len(iv.ent), R
    )
    if merge_valid_test:
        if use_inductive_valid:
            valid, test = i_train, np.concatenate([i_valid, i_test], 0)
        else:
            valid, test = t_valid, np.concatenate([i_valid, i_test], 0)
    else:
        if use_inductive_valid:
            valid, test = i_valid, i_test
        else:
            valid, test = t_valid, i_test
    return InductiveDataset(
        name=name,
        train_graph=train_graph,
        valid_graph=valid_graph,
        test_graph=test_graph,
        graph=graph,
        inductive_graph=inductive_graph,
        train=t_train,
        valid=valid,
        test=test,
    )


register("FB15k237Inductive")(
    partial(_grail_inductive, "FB15k237Inductive", "fb237_%s", "fb15k237")
)
register("WN18RRInductive")(
    partial(_grail_inductive, "WN18RRInductive", "WN18RR_%s", "wn18rr")
)
register("NELLInductive")(
    partial(_grail_inductive, "NELLInductive", "nell_%s", "nell")
)


# ---------------------------------------------------------------------------
# inductive: ILPC / InGram / MTDEA / Hamaguchi four-file families
# ---------------------------------------------------------------------------


def _load_four_file_inductive(
    name,
    train_file,
    inference_file,
    valid_file,
    test_file,
    valid_vocab: str,  # "inference" (ILPC/InGram) or "train" (MTDEA/BM)
    limit_valid_vocab: bool = False,
) -> InductiveDataset:
    tv, iv = Vocab(), Vocab()
    train = _load_file(train_file, tv, "hrt", sep=None)
    inference = _load_file(inference_file, iv, "hrt", sep=None)
    if valid_vocab == "inference":
        # ILPC (:224-247) / InGram (:762-790): valid extends the inference vocab
        valid = _load_file(valid_file, iv, "hrt", sep=None)
        test = _load_file(test_file, iv, "hrt", sep=None)
        train_graph = Graph.from_triplets(train, len(tv.ent), len(tv.rel))
        inf_graph = Graph.from_triplets(inference, len(iv.ent), len(iv.rel))
        return InductiveDataset(
            name=name,
            train_graph=train_graph,
            valid_graph=inf_graph,
            test_graph=inf_graph,
            graph=train_graph,
            inductive_graph=Graph.from_triplets(
                np.concatenate([inference, valid, test], 0), len(iv.ent), len(iv.rel)
            ),
            train=train,
            valid=valid,
            test=test,
        )
    # MTDEA (:916-948) / Hamaguchi (:1069-1100): valid lives on the TRAIN graph
    n_train_ent = len(tv.ent)
    valid = _load_file(valid_file, tv, "hrt", grow=not limit_valid_vocab, sep=None)
    test = _load_file(test_file, iv, "hrt", sep=None)
    train_graph = Graph.from_triplets(train, n_train_ent, len(tv.rel))
    valid_graph = Graph.from_triplets(train, len(tv.ent), len(tv.rel))
    test_graph = Graph.from_triplets(inference, len(iv.ent), len(iv.rel))
    return InductiveDataset(
        name=name,
        train_graph=train_graph,
        valid_graph=valid_graph,
        test_graph=test_graph,
        graph=Graph.from_triplets(
            np.concatenate([train, valid], 0), len(tv.ent), len(tv.rel)
        ),
        inductive_graph=Graph.from_triplets(
            np.concatenate([inference, test], 0), len(iv.ent), len(iv.rel)
        ),
        train=train,
        valid=valid,
        test=test,
    )


def _ilpc(size: str, path: str = _DEFAULT_PATH, **_) -> InductiveDataset:
    root = _cache(path, f"ilpc-{size}")
    zip_path = os.path.join(root, "ilpc2022-v1.0.zip")
    member = "pykeen-ilpc2022-c5ea003/data/{size}/{f}.txt"
    files = {}
    for f in ("train", "inference", "inference_validation", "inference_test"):
        m = member.format(size=size, f=f)
        out = os.path.join(root, m)
        if not os.path.exists(out):
            _download(
                "https://zenodo.org/record/6321299/files/pykeen/ilpc2022-v1.0.zip",
                zip_path,
            )
            out = _extract(zip_path, m, root)
        files[f] = out
    return _load_four_file_inductive(
        f"ILPC2022{size.capitalize()}",
        files["train"], files["inference"], files["inference_validation"],
        files["inference_test"], valid_vocab="inference",
    )


register("ILPC2022SmallInductive")(partial(_ilpc, "small"))
register("ILPC2022LargeInductive")(partial(_ilpc, "large"))

_INGRAM = "https://raw.githubusercontent.com/bdi-lab/InGram/master/data/{d}-{v}/{f}.txt"


def _ingram(prefix, dataset_dir, path=_DEFAULT_PATH, version="25", **_):
    files = []
    for f in ("train", "msg", "valid", "test"):
        dst = _cache(path, f"{prefix}-{version}", f"{prefix}-{version}_{f}.txt")
        if not os.path.exists(dst):
            _download(_INGRAM.format(d=dataset_dir, v=version, f=f), dst)
        files.append(dst)
    return _load_four_file_inductive(
        f"{dataset_dir}Ingram-{version}", *files, valid_vocab="inference"
    )


register("FBIngram")(partial(_ingram, "fb", "FB"))
register("WKIngram")(partial(_ingram, "wk", "WK"))
register("NLIngram")(partial(_ingram, "nl", "NL"))


def _mtdea(name, folder, prefix, versions=None):
    @register(name)
    def build(path=_DEFAULT_PATH, version=None, **_):
        pre = prefix % version if (versions and version is not None) else prefix
        if versions and version is not None:
            assert version in versions, f"unknown version {version}; available {versions}"
        root = _cache(path, folder)  # local dumps only (ref :896)
        return _load_four_file_inductive(
            f"{name}-{version}" if version else name,
            os.path.join(root, f"{pre}-trans/train.txt"),
            os.path.join(root, f"{pre}-ind/observe.txt"),
            os.path.join(root, f"{pre}-trans/valid.txt"),
            os.path.join(root, f"{pre}-ind/test.txt"),
            valid_vocab="train",
            limit_valid_vocab=True,  # always for MTDEA (ref dataset.py:920-923)
        )

    return build


_mtdea("FBNELL", "FBNELL", "FBNELL_v1")
_mtdea("Metafam", "Metafam", "Metafam")
_mtdea("WikiTopicsMT1", "WikiTopics-MT1", "wikidata_%sv1", ["mt", "health", "tax"])
_mtdea("WikiTopicsMT2", "WikiTopics-MT2", "wikidata_%sv1", ["mt2", "org", "sci"])
_mtdea("WikiTopicsMT3", "WikiTopics-MT3", "wikidata_%sv2", ["mt3", "art", "infra"])
_mtdea("WikiTopicsMT4", "WikiTopics-MT4", "wikidata_%sv2", ["mt4", "sci", "health"])

_HAMAGUCHI_VERSIONS = {
    "1k": "Hamaguchi-BM_both-1000",
    "3k": "Hamaguchi-BM_both-3000",
    "5k": "Hamaguchi-BM_both-5000",
    "indigo": "INDIGO-BM",
}
_INDIGO = "https://raw.githubusercontent.com/shuwen-liu-ox/INDIGO/master/data/{d}/{f}"


@register("HamaguchiBM")
def _hamaguchi(path=_DEFAULT_PATH, version="1k", **_):
    d = _HAMAGUCHI_VERSIONS[version]
    files = []
    for f in ("train/train.txt", "test/test-graph.txt", "train/valid.txt", "test/test-fact.txt"):
        dst = _cache(path, f"bm-{version}", f"bm-{version}_{os.path.basename(f)}")
        if not os.path.exists(dst):
            _download(_INDIGO.format(d=d, f=f), dst)
        files.append(dst)
    return _load_four_file_inductive(
        f"HamaguchiBM-{version}", *files, valid_vocab="train"
    )


# ---------------------------------------------------------------------------
# joint + synthetic
# ---------------------------------------------------------------------------


@register("JointDataset")
def _joint(path=_DEFAULT_PATH, graphs=(), verbose=1, **_) -> JointDataset:
    from ..utils.config import lookup

    subs = [lookup(g)(path=path) for g in graphs]
    return JointDataset("Joint[" + ",".join(graphs) + "]", subs)


@register("SynthKG")
def _synth(path=None, num_nodes=60, num_edges=400, num_relations=7, seed=0, **_):
    return synthetic_transductive(
        "SynthKG", num_nodes, num_edges, num_relations, seed
    )


@register("SynthInductiveKG")
def _synth_ind(path=None, num_relations=7, seed=0, **_):
    return synthetic_inductive("SynthInductiveKG", num_relations, seed)


@register("SynthCompositionalKG")
def _synth_comp(path=None, num_nodes=200, seed=0, **_):
    return synthetic_compositional(num_nodes=num_nodes, seed=seed)


@register("SynthJoint")
def _synth_joint(path=None, num_graphs=2, **_):
    return JointDataset(
        "SynthJoint",
        [
            synthetic_transductive(f"synth{i}", 40 + 5 * i, 300, 5, seed=i)
            for i in range(num_graphs)
        ],
    )
