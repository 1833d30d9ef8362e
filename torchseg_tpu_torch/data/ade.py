"""ADE20K dataset (150 classes), counterpart of torchseg_tpu/data/ade.py
(reference furnace/datasets/ade/ade.py).

ADE labels are 1-based on disk; train/eval pipelines shift by -1 so valid
classes are 0..149 and unlabeled becomes -1 (the ignore label), matching the
reference loaders (model/pspnet/ade.pspnet.R50_v1c/dataloader.py:31,
eval.py:28).  Class colors are the real color150 values (embedded as a constant
table instead of loading color150.mat at runtime), so overlays match
the reference exactly.
"""

import numpy as np

from . import image_io
from .base import ManifestDataset

# Standard ADE20K-SceneParsing class names (public dataset metadata).
ADE_CLASS_NAMES = [
    'wall', 'building, edifice', 'sky', 'floor, flooring', 'tree', 'ceiling',
    'road, route', 'bed ', 'windowpane, window ', 'grass', 'cabinet',
    'sidewalk, pavement',
    'person, individual, someone, somebody, mortal, soul', 'earth, ground',
    'door, double door', 'table', 'mountain, mount',
    'plant, flora, plant life', 'curtain, drape, drapery, mantle, pall',
    'chair', 'car, auto, automobile, machine, motorcar', 'water',
    'painting, picture', 'sofa, couch, lounge', 'shelf', 'house', 'sea',
    'mirror', 'rug, carpet, carpeting', 'field', 'armchair', 'seat',
    'fence, fencing', 'desk', 'rock, stone', 'wardrobe, closet, press',
    'lamp', 'bathtub, bathing tub, bath, tub', 'railing, rail', 'cushion',
    'base, pedestal, stand', 'box', 'column, pillar', 'signboard, sign',
    'chest of drawers, chest, bureau, dresser', 'counter', 'sand', 'sink',
    'skyscraper', 'fireplace, hearth, open fireplace',
    'refrigerator, icebox', 'grandstand, covered stand', 'path',
    'stairs, steps', 'runway', 'case, display case, showcase, vitrine',
    'pool table, billiard table, snooker table', 'pillow',
    'screen door, screen', 'stairway, staircase', 'river', 'bridge, span',
    'bookcase', 'blind, screen', 'coffee table, cocktail table',
    'toilet, can, commode, crapper, pot, potty, stool, throne', 'flower',
    'book', 'hill', 'bench', 'countertop',
    'stove, kitchen stove, range, kitchen range, cooking stove',
    'palm, palm tree', 'kitchen island',
    'computer, computing machine, computing device, data processor, electronic computer, information processing system',
    'swivel chair', 'boat', 'bar', 'arcade machine',
    'hovel, hut, hutch, shack, shanty',
    'bus, autobus, coach, charabanc, double-decker, jitney, motorbus, motorcoach, omnibus, passenger vehicle',
    'towel', 'light, light source', 'truck, motortruck', 'tower',
    'chandelier, pendant, pendent', 'awning, sunshade, sunblind',
    'streetlight, street lamp', 'booth, cubicle, stall, kiosk',
    'television receiver, television, television set, tv, tv set, idiot box, boob tube, telly, goggle box',
    'airplane, aeroplane, plane', 'dirt track',
    'apparel, wearing apparel, dress, clothes', 'pole', 'land, ground, soil',
    'bannister, banister, balustrade, balusters, handrail',
    'escalator, moving staircase, moving stairway',
    'ottoman, pouf, pouffe, puff, hassock', 'bottle',
    'buffet, counter, sideboard',
    'poster, posting, placard, notice, bill, card', 'stage', 'van', 'ship',
    'fountain',
    'conveyer belt, conveyor belt, conveyer, conveyor, transporter',
    'canopy', 'washer, automatic washer, washing machine', 'plaything, toy',
    'swimming pool, swimming bath, natatorium', 'stool', 'barrel, cask',
    'basket, handbasket', 'waterfall, falls', 'tent, collapsible shelter',
    'bag', 'minibike, motorbike', 'cradle', 'oven', 'ball',
    'food, solid food', 'step, stair', 'tank, storage tank',
    'trade name, brand name, brand, marque', 'microwave, microwave oven',
    'pot, flowerpot', 'animal, animate being, beast, brute, creature, fauna',
    'bicycle, bike, wheel, cycle ', 'lake',
    'dishwasher, dish washer, dishwashing machine',
    'screen, silver screen, projection screen', 'blanket, cover',
    'sculpture', 'hood, exhaust hood', 'sconce', 'vase',
    'traffic light, traffic signal, stoplight', 'tray',
    'ashcan, trash can, garbage can, wastebin, ash bin, ash-bin, ashbin, dustbin, trash barrel, trash bin',
    'fan', 'pier, wharf, wharfage, dock', 'crt screen', 'plate',
    'monitor, monitoring device', 'bulletin board, notice board', 'shower',
    'radiator', 'glass, drinking glass', 'clock', 'flag',
]


# The standard ADE20K color150 palette (public dataset metadata; the
# reference loads furnace/datasets/ade/color150.mat and flips channels
# to BGR, ade.py:34-41).  [0, 0, 0] is prepended for background below.
ADE_COLOR150_BGR = [
    [120, 120, 120], [120, 120, 180], [230, 230, 6], [50, 50, 80], [3, 200, 4],
    [80, 120, 120], [140, 140, 140], [255, 5, 204], [230, 230, 230], [7, 250, 4],
    [255, 5, 224], [7, 255, 235], [61, 5, 150], [70, 120, 120], [51, 255, 8],
    [82, 6, 255], [140, 255, 143], [4, 255, 204], [7, 51, 255], [3, 70, 204],
    [200, 102, 0], [250, 230, 61], [51, 6, 255], [255, 102, 11], [71, 7, 255],
    [224, 9, 255], [230, 7, 9], [220, 220, 220], [92, 9, 255], [255, 9, 112],
    [214, 255, 8], [224, 255, 7], [6, 184, 255], [71, 255, 10], [10, 41, 255],
    [255, 255, 7], [8, 255, 224], [255, 8, 102], [6, 61, 255], [7, 194, 255],
    [8, 122, 255], [20, 255, 0], [41, 8, 255], [153, 5, 255], [255, 51, 6],
    [255, 12, 235], [20, 150, 160], [255, 163, 0], [140, 140, 140], [15, 10, 250],
    [0, 255, 20], [0, 255, 31], [0, 31, 255], [0, 224, 255], [0, 255, 153],
    [255, 0, 0], [0, 71, 255], [255, 235, 0], [255, 173, 0], [255, 0, 31],
    [200, 200, 11], [0, 82, 255], [245, 255, 0], [255, 61, 0], [112, 255, 0],
    [133, 255, 0], [0, 0, 255], [0, 163, 255], [0, 102, 255], [0, 255, 194],
    [255, 143, 0], [0, 255, 51], [255, 82, 0], [41, 255, 0], [173, 255, 0],
    [255, 0, 10], [0, 255, 173], [153, 255, 0], [0, 92, 255], [255, 0, 255],
    [245, 0, 255], [102, 0, 255], [0, 173, 255], [20, 0, 255], [184, 184, 255],
    [255, 31, 0], [61, 255, 0], [255, 71, 0], [204, 0, 255], [194, 255, 0],
    [82, 255, 0], [255, 10, 0], [255, 112, 0], [255, 0, 51], [255, 194, 0],
    [255, 122, 0], [163, 255, 0], [0, 153, 255], [10, 255, 0], [0, 112, 255],
    [0, 255, 143], [255, 0, 82], [0, 255, 163], [0, 235, 255], [170, 184, 8],
    [255, 0, 133], [92, 255, 0], [255, 0, 184], [31, 0, 255], [255, 184, 0],
    [255, 214, 0], [112, 0, 255], [0, 255, 92], [255, 224, 0], [255, 224, 112],
    [160, 184, 70], [255, 0, 163], [255, 0, 153], [0, 255, 71], [163, 0, 255],
    [0, 204, 255], [143, 0, 255], [235, 255, 0], [0, 255, 133], [235, 0, 255],
    [255, 0, 245], [122, 0, 255], [0, 245, 255], [212, 190, 10], [0, 255, 214],
    [255, 204, 0], [255, 0, 20], [0, 255, 255], [255, 153, 0], [255, 41, 0],
    [204, 255, 0], [255, 0, 41], [0, 255, 41], [255, 0, 173], [255, 245, 0],
    [255, 0, 71], [255, 0, 122], [184, 255, 0], [255, 92, 0], [0, 255, 184],
    [255, 133, 0], [0, 214, 255], [194, 194, 25], [0, 255, 102], [255, 0, 92],
]


def _ade_colors(n=150):
    # background/unlabeled first, then the color150 table (ade.py:40-41)
    return [[0, 0, 0]] + [list(c) for c in ADE_COLOR150_BGR[:n]]


class ADE(ManifestDataset):
    num_classes = 150
    ignore_label = -1

    def _fetch_data(self, img_path, gt_path, dtype=np.float32):
        # gt read as float32 (reference ade.py:20-24)
        img = self._open_image(img_path)
        gt = self._open_image(gt_path, image_io.GRAYSCALE, dtype=dtype)
        return img, gt

    @staticmethod
    def _process_item_names(item: str):
        # ADE manifests hold only the image name; gt path is derived
        # (reference ade.py:26-32)
        item = item.strip()
        return item, item.split(".")[0] + ".png"

    @classmethod
    def get_class_colors(cls):
        return _ade_colors(cls.num_classes)

    @classmethod
    def get_class_names(cls):
        return list(ADE_CLASS_NAMES)
