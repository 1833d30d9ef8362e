"""Manifest generator (counterpart of torchseg_tpu/tools/make_manifest.py):
builds the tab-separated ``img<TAB>gt`` text files that the datasets read
(``--train-source`` / ``--eval-source`` of the two command lines; the
reference ships them as external config_new/*.txt) from the standard
on-disk layouts.

Usage:
  python -m torchseg_tpu_torch.tools.make_manifest cityscapes \\
      /data/cityscapes --split train --out train.txt
  python -m torchseg_tpu_torch.tools.make_manifest voc \\
      /data/VOCdevkit/VOC2012 --list ImageSets/Segmentation/train.txt \\
      --out train.txt
  python -m torchseg_tpu_torch.tools.make_manifest ade \\
      /data/ADEChallengeData2016 --split training --out train.txt
"""

import argparse
import os


def cityscapes_pairs(root: str, split: str):
    img_dir = os.path.join(root, "leftImg8bit", split)
    for city in sorted(os.listdir(img_dir)):
        cdir = os.path.join(img_dir, city)
        for fn in sorted(os.listdir(cdir)):
            if not fn.endswith("_leftImg8bit.png"):
                continue
            stem = fn[:-len("_leftImg8bit.png")]
            gt = f"gtFine/{split}/{city}/{stem}_gtFine_labelTrainIds.png"
            if not os.path.exists(os.path.join(root, gt)):
                gt = f"gtFine/{split}/{city}/{stem}_gtFine_labelIds.png"
            yield f"leftImg8bit/{split}/{city}/{fn}", gt


def voc_pairs(root: str, list_file: str):
    with open(os.path.join(root, list_file)) as f:
        for line in f:
            stem = line.strip()
            if stem:
                yield (f"JPEGImages/{stem}.jpg",
                       f"SegmentationClass/{stem}.png")


def ade_entries(root: str, split: str):
    img_dir = os.path.join(root, "images", split)
    for fn in sorted(os.listdir(img_dir)):
        if fn.endswith(".jpg"):
            yield f"images/{split}/{fn}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["cityscapes", "voc", "ade"])
    p.add_argument("root")
    p.add_argument("--split", default="train")
    p.add_argument("--list", default=None, help="VOC ImageSets list file")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.dataset == "voc" and not args.list:
        p.error("--list is required for VOC")

    with open(args.out, "w") as f:
        if args.dataset == "cityscapes":
            for img, gt in cityscapes_pairs(args.root, args.split):
                f.write(f"{img}\t{gt}\n")
        elif args.dataset == "voc":
            for img, gt in voc_pairs(args.root, args.list):
                f.write(f"{img}\t{gt}\n")
        else:  # ADE manifests hold only the image path (data/ade.py)
            for img in ade_entries(args.root, args.split):
                f.write(f"{img}\n")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
