"""Dataset class-name vocabularies (`mmdet/core/evaluation/class_names.py`).

The port's own copy of `panoswintransformerobjectdetection_tpu/core/
class_names.py`: the public label tables (ILSVRC, COCO, VOC, Cityscapes,
WIDER).  The COCO and VOC tables come from `data.datasets`, imported when
asked for.
"""


def wider_face_classes():
    return ["face"]


def voc_classes():
    from ..data.datasets import VOC_CLASSES
    return list(VOC_CLASSES)


def coco_classes():
    """COCO-2017 80 classes, mmdet underscore convention."""
    from ..data.datasets import COCO_CLASSES
    return [c.replace(" ", "_") for c in COCO_CLASSES]


def cityscapes_classes():
    return ["person", "rider", "car", "truck", "bus", "train",
            "motorcycle", "bicycle"]


def imagenet_det_classes():
    """ILSVRC2014 DET 200-class vocabulary."""
    return [
        "accordion", "airplane", "ant", "antelope", "apple", "armadillo",
        "artichoke", "axe", "baby_bed", "backpack", "bagel", "balance_beam",
        "banana", "band_aid", "banjo", "baseball", "basketball",
        "bathing_cap", "beaker", "bear", "bee", "bell_pepper", "bench",
        "bicycle", "binder", "bird", "bookshelf", "bow_tie", "bow", "bowl",
        "brassiere", "burrito", "bus", "butterfly", "camel", "can_opener",
        "car", "cart", "cattle", "cello", "centipede", "chain_saw", "chair",
        "chime", "cocktail_shaker", "coffee_maker", "computer_keyboard",
        "computer_mouse", "corkscrew", "cream", "croquet_ball", "crutch",
        "cucumber", "cup_or_mug", "diaper", "digital_clock", "dishwasher",
        "dog", "domestic_cat", "dragonfly", "drum", "dumbbell",
        "electric_fan", "elephant", "face_powder", "fig", "filing_cabinet",
        "flower_pot", "flute", "fox", "french_horn", "frog", "frying_pan",
        "giant_panda", "goldfish", "golf_ball", "golfcart", "guacamole",
        "guitar", "hair_dryer", "hair_spray", "hamburger", "hammer",
        "hamster", "harmonica", "harp", "hat_with_a_wide_brim",
        "head_cabbage", "helmet", "hippopotamus", "horizontal_bar", "horse",
        "hotdog", "iPod", "isopod", "jellyfish", "koala_bear", "ladle",
        "ladybug", "lamp", "laptop", "lemon", "lion", "lipstick", "lizard",
        "lobster", "maillot", "maraca", "microphone", "microwave",
        "milk_can", "miniskirt", "monkey", "motorcycle", "mushroom", "nail",
        "neck_brace", "oboe", "orange", "otter", "pencil_box",
        "pencil_sharpener", "perfume", "person", "piano", "pineapple",
        "ping-pong_ball", "pitcher", "pizza", "plastic_bag", "plate_rack",
        "pomegranate", "popsicle", "porcupine", "power_drill", "pretzel",
        "printer", "puck", "punching_bag", "purse", "rabbit", "racket",
        "ray", "red_panda", "refrigerator", "remote_control",
        "rubber_eraser", "rugby_ball", "ruler", "salt_or_pepper_shaker",
        "saxophone", "scorpion", "screwdriver", "seal", "sheep", "ski",
        "skunk", "snail", "snake", "snowmobile", "snowplow",
        "soap_dispenser", "soccer_ball", "sofa", "spatula", "squirrel",
        "starfish", "stethoscope", "stove", "strainer", "strawberry",
        "stretcher", "sunglasses", "swimming_trunks", "swine", "syringe",
        "table", "tape_player", "tennis_ball", "tick", "tie", "tiger",
        "toaster", "traffic_light", "train", "trombone", "trumpet",
        "turtle", "tv_or_monitor", "unicycle", "vacuum", "violin",
        "volleyball", "waffle_iron", "washer", "water_bottle", "watercraft",
        "whale", "wine_bottle", "zebra"]


def imagenet_vid_classes():
    """ILSVRC2015 VID 30-class vocabulary."""
    return [
        "airplane", "antelope", "bear", "bicycle", "bird", "bus", "car",
        "cattle", "dog", "domestic_cat", "elephant", "fox", "giant_panda",
        "hamster", "horse", "lion", "lizard", "monkey", "motorcycle",
        "rabbit", "red_panda", "sheep", "snake", "squirrel", "tiger",
        "train", "turtle", "watercraft", "whale", "zebra"]


dataset_aliases = {
    "voc": ["voc", "pascal_voc", "voc07", "voc12"],
    "imagenet_det": ["det", "imagenet_det", "ilsvrc_det"],
    "imagenet_vid": ["vid", "imagenet_vid", "ilsvrc_vid"],
    "coco": ["coco", "mscoco", "ms_coco"],
    "wider_face": ["WIDERFaceDataset", "wider_face", "WIDERFace"],
    "cityscapes": ["cityscapes"],
}

_CLASS_FNS = {
    "voc": voc_classes,
    "imagenet_det": imagenet_det_classes,
    "imagenet_vid": imagenet_vid_classes,
    "coco": coco_classes,
    "wider_face": wider_face_classes,
    "cityscapes": cityscapes_classes,
}


def get_classes(dataset: str):
    """`class_names.py:102` (explicit table dispatch, no eval())."""
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be a str, got {type(dataset)}")
    for name, aliases in dataset_aliases.items():
        if dataset in aliases:
            return _CLASS_FNS[name]()
    raise ValueError(f"Unrecognized dataset: {dataset}")
