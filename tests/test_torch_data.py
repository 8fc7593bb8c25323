"""reftr_torch's data pipeline against reftr_tpu's, on the CPU.

The same seeded inputs go through both packages. Everything here is
compared exactly: token ids, masks and offsets, the native image ops'
bytes, LSAP assignments, sampler orders, and every array of every dataset
item and loader batch (canvases, validity masks, boxes, token ids). Both
packages compile the same C++ sources with the same flags, so no
tolerance is needed.
"""

import json
import os

import numpy as np
import pytest

from reftr_tpu.core.config import DataConfig as JaxDataConfig
from reftr_tpu.data import build as jax_build
from reftr_tpu.data import datasets as jax_datasets
from reftr_tpu.data import loader as jax_loader
from reftr_tpu.data import native as jax_native
from reftr_tpu.data import samplers as jax_samplers
from reftr_tpu.data import transforms as jax_transforms
from reftr_torch.core.config import DataConfig
from reftr_torch.data import build, datasets, loader, native, samplers
from reftr_torch.data import transforms

WORDPIECE_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "a", "man", "woman", "dog",
    "in", "red", "shirt", "hat", "##s", "##ing", "##ed", "play", "walk",
    "left", "right", "on", "with", "his", "bi", "##cycle", ".", ",", "!",
    "'", "##t", "is", "person", "##son", "per", "green", "blue",
]
SENTENCES = [
    "the man in the red shirt", "A woman walking her dog!",
    "dogs playing on the left, with his bicycle.", "person's hat",
    "", "the blue green red left right man woman dog hat shirt in on",
    "unknownword walked",
]


def write_lines(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    return {"synthetic": datasets.write_synthetic_vocab(
                str(d / "synthetic.txt")),
            "wordpiece": write_lines(d / "wordpiece.txt", WORDPIECE_VOCAB)}


@pytest.fixture(scope="module")
def toks(vocab_files):
    path = vocab_files["synthetic"]
    return jax_native.WordPieceTokenizer(path), native.WordPieceTokenizer(path)


def assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("vocab", ["synthetic", "wordpiece"])
@pytest.mark.parametrize("max_length", [6, 16])
def test_wordpiece_tokenizers_agree(vocab_files, vocab, max_length):
    path = vocab_files[vocab]
    ref, port = (jax_native.WordPieceTokenizer(path),
                 native.WordPieceTokenizer(path))
    assert port.vocab_size == ref.vocab_size
    assert (port.pad_id, port.cls_id, port.sep_id, port.unk_id) == (
        ref.pad_id, ref.cls_id, ref.sep_id, ref.unk_id)
    for text in SENTENCES:
        for pad in (True, False):
            want = ref.encode(text, max_length, pad=pad)
            got = port.encode(text, max_length, pad=pad)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w, err_msg=text)
        ids, mask, offsets = port.encode(text, max_length)
        for pos in range(len(text) + 1):
            assert port.char_to_token(offsets, mask, pos) == \
                ref.char_to_token(offsets, mask, pos)


def _bytes_to_unicode():
    """GPT-2's byte -> symbol table, as bpe.cpp builds it."""
    bs = (list(range(33, 127)) + list(range(161, 173))
          + list(range(174, 256)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def test_byte_level_bpe_tokenizers_agree(tmp_path):
    """A tiny vocab.json / merges.txt written here: every byte symbol and a
    few merges (the Ġ prefix is a space)."""
    symbols = sorted(set(_bytes_to_unicode().values()))
    merges = ["Ġ t", "h e", "Ġt he", "Ġ d", "o g", "Ġd og", "e d", "Ġ r",
              "Ġr ed", "i n", "Ġ in", "Ġin g"]
    vocab = {tok: i for i, tok in enumerate(
        ["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + symbols
        + [m.replace(" ", "") for m in merges])}
    vj, mt = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vj.write_text(json.dumps(vocab))
    mt.write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    ref = jax_native.ByteLevelBPETokenizer(str(vj), str(mt))
    port = native.ByteLevelBPETokenizer(str(vj), str(mt))
    assert port.vocab_size == ref.vocab_size == len(vocab)
    assert (port.pad_id, port.cls_id, port.sep_id) == (
        ref.pad_id, ref.cls_id, ref.sep_id)
    texts = SENTENCES + ["the dog, the red dog ding!", "  spaced  out ",
                         "naïve café"]
    n_merged = 0
    for text in texts:
        for max_length in (5, 24):
            want = ref.encode(text, max_length)
            got = port.encode(text, max_length)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=text)
            n_merged += int((got[0] >= 5 + len(symbols)).sum())
    assert n_merged > 0  # the merges were applied, not only bytes


@pytest.mark.parametrize("src_hw,out_hw", [
    ((37, 50), (32, 43)), ((64, 48), (120, 90)), ((5, 7), (5, 7)),
    ((640, 480), (640, 480)), ((33, 97), (11, 32))])
def test_native_image_ops_are_byte_equal(src_hw, out_hw):
    rng = np.random.default_rng(sum(src_hw) + sum(out_hw))
    img = rng.integers(0, 256, size=src_hw + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear(img, out_hw),
                                  jax_native.resize_bilinear(img, out_hw))
    for s, v in ((1.0, 0.7), (1.3, 1.4), (0.5, 1.0)):
        np.testing.assert_array_equal(native.hsv_jitter(img, s, v),
                                      jax_native.hsv_jitter(img, s, v))
    canvas = (max(src_hw) + 3, max(src_hw) + 9)
    np.testing.assert_array_equal(native.pack_canvas(img, canvas),
                                  jax_native.pack_canvas(img, canvas))


@pytest.mark.parametrize("n,m", [(1, 1), (3, 5), (8, 8), (6, 20)])
def test_lsap_assignments_agree(n, m):
    rng = np.random.default_rng(n * 100 + m)
    for _ in range(5):
        cost = rng.normal(size=(n, m))
        np.testing.assert_array_equal(native.lsap(cost),
                                      jax_native.lsap(cost))
    with pytest.raises(ValueError):
        native.lsap(np.zeros((m + 1, m)))


@pytest.mark.parametrize("train", [True, False])
def test_transform_sample_agrees(train):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(50, 37, 3), dtype=np.uint8)
    boxes = np.array([[3, 4, 30, 45], [0, 0, 37, 50]], np.float32)
    mask = (rng.random((50, 37)) > 0.5).astype(np.float32)
    for size, max_size in ((32, 40), (24, 24), (64, 64)):
        want = jax_transforms.transform_sample(
            img, boxes, size, max_size, train, np.random.default_rng(7),
            0.4, seg_mask=mask)
        got = transforms.transform_sample(
            img, boxes, size, max_size, train, np.random.default_rng(7),
            0.4, seg_mask=mask)
        assert got.valid_hw == want.valid_hw and got.orig_hw == want.orig_hw
        for name in ("canvas", "boxes_cxcywh", "mask_canvas"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_box_transforms_agree():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(30, 40, 3), dtype=np.uint8)
    boxes = np.array([[2, 3, 20, 25], [30, 1, 39, 5], [35, 25, 38, 29]],
                     np.float32)
    masks = rng.random((3, 30, 40)) > 0.5
    for region in ((2, 5, 20, 28), transforms.center_crop_region(
            30, 40, 16, 16), transforms.random_crop_region(
            30, 40, 10, 12, np.random.default_rng(1))):
        for g, w in zip(transforms.crop(img, boxes, region, masks),
                        jax_transforms.crop(img, boxes, region, masks)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(transforms.hflip(img, boxes, masks),
                    jax_transforms.hflip(img, boxes, masks)):
        np.testing.assert_array_equal(g, w)
    assert transforms.center_crop_region(31, 40, 16, 16) == \
        jax_transforms.center_crop_region(31, 40, 16, 16)
    for hw in ((480, 640), (640, 480), (333, 500), (640, 640), (100, 900)):
        for size, max_size in ((640, 640), (512, 640), (320, None)):
            assert transforms.resize_target_hw(*hw, size, max_size) == \
                jax_transforms.resize_target_hw(*hw, size, max_size)


@pytest.mark.parametrize("n,replicas,rank", [
    (17, 1, 0), (17, 4, 0), (17, 4, 3), (64, 2, 1), (5, 8, 7)])
def test_samplers_agree(n, replicas, rank):
    for seed in (0, 42):
        for epoch in (0, 1, 7):
            for shuffle in (True, False):
                a = samplers.ShardedSampler(n, replicas, rank, shuffle, seed)
                b = jax_samplers.ShardedSampler(n, replicas, rank, shuffle,
                                                seed)
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                assert list(a) == list(b) and len(a) == len(b)
            for local_size in (1, 2):
                if replicas % local_size:
                    continue
                kw = dict(local_rank=rank % local_size,
                          local_size=local_size, shuffle=True, seed=seed)
                a = samplers.NodeShardedSampler(n, replicas, rank, **kw)
                b = jax_samplers.NodeShardedSampler(n, replicas, rank, **kw)
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                assert list(a) == list(b) and len(a) == len(b)


@pytest.mark.parametrize("img_size,canvas,items,with_masks", [
    (32, 32, range(12), False), (32, 40, range(4), False),
    (640, 640, (0, 5), False), (32, 40, range(6), True),
    (640, 640, (0, 3), True)])
def test_synthetic_items_agree(toks, img_size, canvas, items, with_masks):
    """Items byte-equal to JAX's; with masks, each mask is its box's
    rectangle on the canvas."""
    ref_tok, port_tok = toks
    kw = dict(n=16, img_size=img_size, canvas=canvas, max_query_len=12,
              box_frac=(0.25, 0.5), with_masks=with_masks)
    ref = jax_datasets.SyntheticGroundingDataset(ref_tok, **kw)
    port = datasets.SyntheticGroundingDataset(port_tok, **kw)
    assert len(port) == len(ref)
    for i in items:
        (s1, t1), (s2, t2) = port[i], ref[i]
        assert_trees_equal(s1, s2)
        assert_trees_equal(t1, t2)
        assert ("masks" in t1) == with_masks
        if with_masks:
            assert t1["masks"].shape == (canvas, canvas) and t1["mask_valid"]
            h, w = t1["size"]
            cx, cy, bw, bh = t1["boxes"][0] * [w, h, w, h]
            ys, xs = np.nonzero(t1["masks"])
            assert abs(xs.min() - (cx - bw / 2)) <= 1
            assert abs(xs.max() + 1 - (cx + bw / 2)) <= 1
            assert abs(ys.min() - (cy - bh / 2)) <= 1
            assert abs(ys.max() + 1 - (cy + bh / 2)) <= 1


@pytest.fixture(scope="module")
def resc_root(tmp_path_factory):
    """PNG images (RGB and grayscale) and refcoco-style .json annotations
    (file, ann id, xywh box, phrase) of train and val."""
    from PIL import Image

    root = tmp_path_factory.mktemp("resc")
    im_dir = root / "images"
    im_dir.mkdir()
    rng = np.random.default_rng(5)
    shapes = [(48, 64), (70, 50), (33, 33), (80, 21), (40, 60)]
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        if i == 2:
            Image.fromarray(img[..., 0]).save(im_dir / f"im{i}.png")
        else:
            Image.fromarray(img).save(im_dir / f"im{i}.png")
    ann_dir = root / "anns" / "unc"
    ann_dir.mkdir(parents=True)
    phrases = ["the man in the red shirt", "dog on the left",
               "A blue hat!", "person", "green bicycle"]
    for split, ids in (("train", range(5)), ("val", (1, 3))):
        recs = []
        for i in ids:
            h, w = shapes[i]
            x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
            recs.append([f"im{i}.png", 100 + i,
                         [x0, y0, int(rng.integers(2, w - x0)),
                          int(rng.integers(2, h - y0))], phrases[i]])
        (ann_dir / f"unc_{split}.json").write_text(json.dumps(recs))
    # refcoco segmentation annotations (file, seg file, xyxy box, phrase)
    # and each mask as .npy over its image
    seg_dir = root / "seg"
    (seg_dir / "anns" / "unc").mkdir(parents=True)
    (seg_dir / "masks").mkdir()
    for split, ids in (("train", range(5)), ("val", (0, 2, 4))):
        recs = []
        for i in ids:
            h, w = shapes[i]
            m = np.zeros((h, w), np.uint8)
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            y1, x1 = int(rng.integers(y0 + 2, h)), int(rng.integers(x0 + 2, w))
            m[y0:y1, x0:x1] = 1
            m[y0, x0] = 0
            np.save(seg_dir / "masks" / f"seg{i}.npy", m)
            recs.append([f"im{i}.png", f"seg{i}.npy",
                         [float(x0), float(y0), float(x1), float(y1)],
                         phrases[i]])
        (seg_dir / "anns" / "unc" / f"unc_{split}.json").write_text(
            json.dumps(recs))
    return root


@pytest.mark.parametrize("split,train", [("train", True), ("val", False)])
def test_refer_seg_items_agree(vocab_files, resc_root, split, train):
    """ReferSegDataset on a fixture written here: every array of every
    item byte-equal to JAX's, masks included, with train-time
    augmentation and without."""
    path = vocab_files["wordpiece"]
    kw = dict(img_size=32, max_img_size=40, max_query_len=10, train=train,
              hsv_fraction=0.5, seed=3,
              mask_dir=str(resc_root / "seg" / "masks"))
    args = (str(resc_root / "seg" / "anns"), str(resc_root / "images"),
            "unc", split)
    ref = jax_datasets.ReferSegDataset(
        *args, jax_native.WordPieceTokenizer(path), **kw)
    port = datasets.ReferSegDataset(*args, native.WordPieceTokenizer(path),
                                    **kw)
    assert len(port) == len(ref)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        for i in range(len(ref)):
            (s1, t1), (s2, t2) = port[i], ref[i]
            assert_trees_equal(s1, s2)
            assert_trees_equal(t1, t2)
            assert t1["masks"].any() and t1["mask_valid"]


@pytest.mark.parametrize("split,train", [("train", True), ("train", False),
                                         ("trainval", True), ("val", False)])
def test_resc_items_agree(vocab_files, resc_root, split, train):
    path = vocab_files["wordpiece"]
    kw = dict(img_size=32, max_img_size=40, max_query_len=10, train=train,
              hsv_fraction=0.5, seed=3)
    args = (str(resc_root / "anns"), str(resc_root / "images"), "unc", split)
    ref = jax_datasets.ReferDatasetResc(
        *args, jax_native.WordPieceTokenizer(path), **kw)
    port = datasets.ReferDatasetResc(*args, native.WordPieceTokenizer(path),
                                     **kw)
    assert len(port) == len(ref)
    for epoch in (0, 2):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        for i in range(len(ref)):
            (s1, t1), (s2, t2) = port[i], ref[i]
            assert_trees_equal(s1, s2)
            assert_trees_equal(t1, t2)


def _configs(**kw):
    return DataConfig(**kw), JaxDataConfig(**kw)


@pytest.mark.parametrize("split,train", [("train", True), ("val", False)])
def test_build_refer_dataset_agrees(toks, vocab_files, resc_root, split,
                                    train):
    cfg, jcfg = _configs(dataset="synthetic", img_size=32, max_img_size=40,
                         max_query_len=12, synthetic_n=10,
                         synthetic_box_frac=(0.25, 0.5))
    port = build.build_refer_dataset(split, cfg, toks[1], train)
    ref = jax_build.build_refer_dataset(split, jcfg, toks[0], train)
    assert len(port) == len(ref) == (10 if train else 64)
    for i in (0, 9):
        for g, w in zip(port[i], ref[i]):
            assert_trees_equal(g, w)
    # refcoco_unc: <data_root>/annotations_resc/unc and the train2014 images
    root = resc_root / "data"
    (root / "annotations_resc").mkdir(parents=True, exist_ok=True)
    (root / "refcoco" / "images").mkdir(parents=True, exist_ok=True)
    for link, target in ((root / "annotations_resc" / "unc",
                          resc_root / "anns" / "unc"),
                         (root / "refcoco" / "images" / "train2014",
                          resc_root / "images")):
        if not link.exists():
            os.symlink(target, link)
    cfg, jcfg = _configs(dataset="refcoco_unc", data_root=str(root),
                         img_size=32, max_img_size=40, max_query_len=10)
    path = vocab_files["wordpiece"]
    port = build.build_refer_dataset(split, cfg,
                                     native.WordPieceTokenizer(path), train)
    ref = jax_build.build_refer_dataset(
        split, jcfg, jax_native.WordPieceTokenizer(path), train)
    assert len(port) == len(ref)
    for i in range(len(ref)):
        for g, w in zip(port[i], ref[i]):
            assert_trees_equal(g, w)


@pytest.mark.parametrize("split,train", [("train", True), ("val", False)])
def test_build_refer_dataset_with_masks_agrees(toks, vocab_files, resc_root,
                                               split, train):
    """masks: the synthetic fixture with its masks, and refcoco's
    segmentation dataset under <data_root>/refcoco/{anns,masks}."""
    cfg, jcfg = _configs(dataset="synthetic", img_size=32, max_img_size=40,
                         max_query_len=12, synthetic_n=10)
    port = build.build_refer_dataset(split, cfg, toks[1], train, masks=True)
    ref = jax_build.build_refer_dataset(split, jcfg, toks[0], train,
                                        masks=True)
    for i in (0, 9):
        for g, w in zip(port[i], ref[i]):
            assert_trees_equal(g, w)
        assert "masks" in port[i][1]
    root = resc_root / "segdata"
    (root / "refcoco" / "images").mkdir(parents=True, exist_ok=True)
    for link, target in ((root / "refcoco" / "anns", resc_root / "seg"
                          / "anns"),
                         (root / "refcoco" / "masks", resc_root / "seg"
                          / "masks"),
                         (root / "refcoco" / "images" / "train2014",
                          resc_root / "images")):
        if not link.exists():
            os.symlink(target, link)
    cfg, jcfg = _configs(dataset="refcoco_unc", data_root=str(root),
                         img_size=32, max_img_size=40, max_query_len=10)
    path = vocab_files["wordpiece"]
    port = build.build_refer_dataset(split, cfg,
                                     native.WordPieceTokenizer(path), train,
                                     masks=True)
    ref = jax_build.build_refer_dataset(
        split, jcfg, jax_native.WordPieceTokenizer(path), train, masks=True)
    assert isinstance(port, datasets.ReferSegDataset)
    assert len(port) == len(ref)
    for i in range(len(ref)):
        for g, w in zip(port[i], ref[i]):
            assert_trees_equal(g, w)


def test_concat_dataset_agrees():
    parts = [list(range(3)), list(range(10, 15)), list(range(20, 22))]
    port, ref = build.ConcatDataset(parts), jax_build.ConcatDataset(parts)
    assert len(port) == len(ref) == 10
    assert [port[i] for i in range(10)] == [ref[i] for i in range(10)]


@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, False),
                                               (False, True)])
def test_loader_batches_agree(toks, drop_last, shuffle):
    """13 items in batches of 4: with drop_last=False the last batch holds
    one item and three copies of it with box_valid zeroed."""
    kw = dict(n=13, img_size=32, max_query_len=12)
    ref_ds = jax_datasets.SyntheticGroundingDataset(toks[0], **kw)
    port_ds = datasets.SyntheticGroundingDataset(toks[1], **kw)
    ref = jax_loader.DataLoader(
        ref_ds, 4, jax_samplers.ShardedSampler(13, shuffle=shuffle, seed=1),
        num_workers=3, drop_last=drop_last)
    port = loader.DataLoader(
        port_ds, 4, samplers.ShardedSampler(13, shuffle=shuffle, seed=1),
        num_workers=3, drop_last=drop_last)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) == len(ref)
        for (s1, t1), (s2, t2) in zip(got, want):
            assert_trees_equal(s1, s2)
            assert_trees_equal(t1, t2)
    if not drop_last:
        assert got[-1][1]["box_valid"].tolist() == [[True], [False],
                                                     [False], [False]]


def test_loader_pads_the_last_batch_with_zero_mask_valid(toks):
    """RES: masks and mask_valid are collated, and the padded rows of the
    last batch have mask_valid zero, as in JAX's loader."""
    kw = dict(n=6, img_size=32, max_query_len=12, with_masks=True)
    port = loader.DataLoader(datasets.SyntheticGroundingDataset(toks[1], **kw),
                             4, num_workers=2, drop_last=False)
    ref = jax_loader.DataLoader(
        jax_datasets.SyntheticGroundingDataset(toks[0], **kw), 4,
        num_workers=2, drop_last=False)
    got, want = list(port), list(ref)
    for (s1, t1), (s2, t2) in zip(got, want):
        assert_trees_equal(s1, s2)
        assert_trees_equal(t1, t2)
    assert got[-1][1]["masks"].shape == (4, 32, 32)
    assert got[-1][1]["mask_valid"].tolist() == [True, True, False, False]
    assert got[0][1]["mask_valid"].all()


def test_loader_surfaces_worker_errors(toks):
    class Broken(datasets.SyntheticGroundingDataset):
        def __getitem__(self, idx):
            if idx == 5:
                raise ValueError("item 5 is broken")
            return super().__getitem__(idx)

    ds = Broken(toks[1], n=12, img_size=32)
    batches = []
    with pytest.raises(ValueError, match="item 5 is broken"):
        for b in loader.DataLoader(ds, 2, num_workers=2):
            batches.append(b)
    assert len(batches) <= 2
