"""ScanNet / ScanNet200 class metadata (the port's copy of
ao_tpu/datasets/preprocessing/scannet_meta.py; the port imports nothing of
ao_tpu).

Public benchmark constants (the raw-category id -> class name tables of the
ScanNet and ScanNet200 benchmarks), stored as (nyu40/raw id, name) pairs.
Reference keeps them in
pointcept/datasets/preprocessing/scannet/meta_data/scannet200_constants.py.
``VALID_CLASS_IDS_20`` / ``VALID_CLASS_IDS_200`` map a predicted class index
to the raw id that the benchmark submission files hold. The ScanNet200
configs import ``CLASS_LABELS_200`` from the JAX package's module name;
``utils.config`` serves this module under that name while it runs a config.
"""

# (raw category id, class name) for the 20-class ScanNet benchmark
SCANNET_20 = (
    (1, 'wall'), (2, 'floor'), (3, 'cabinet'),
    (4, 'bed'), (5, 'chair'), (6, 'sofa'),
    (7, 'table'), (8, 'door'), (9, 'window'),
    (10, 'bookshelf'), (11, 'picture'), (12, 'counter'),
    (14, 'desk'), (16, 'curtain'), (24, 'refrigerator'),
    (28, 'shower curtain'), (33, 'toilet'), (34, 'sink'),
    (36, 'bathtub'), (39, 'otherfurniture'),
)

# (raw category id, class name) for the 200-class ScanNet200 benchmark
SCANNET_200 = (
    (1, 'wall'), (2, 'chair'), (3, 'floor'),
    (4, 'table'), (5, 'door'), (6, 'couch'),
    (7, 'cabinet'), (8, 'shelf'), (9, 'desk'),
    (10, 'office chair'), (11, 'bed'), (13, 'pillow'),
    (14, 'sink'), (15, 'picture'), (16, 'window'),
    (17, 'toilet'), (18, 'bookshelf'), (19, 'monitor'),
    (21, 'curtain'), (22, 'book'), (23, 'armchair'),
    (24, 'coffee table'), (26, 'box'), (27, 'refrigerator'),
    (28, 'lamp'), (29, 'kitchen cabinet'), (31, 'towel'),
    (32, 'clothes'), (33, 'tv'), (34, 'nightstand'),
    (35, 'counter'), (36, 'dresser'), (38, 'stool'),
    (39, 'cushion'), (40, 'plant'), (41, 'ceiling'),
    (42, 'bathtub'), (44, 'end table'), (45, 'dining table'),
    (46, 'keyboard'), (47, 'bag'), (48, 'backpack'),
    (49, 'toilet paper'), (50, 'printer'), (51, 'tv stand'),
    (52, 'whiteboard'), (54, 'blanket'), (55, 'shower curtain'),
    (56, 'trash can'), (57, 'closet'), (58, 'stairs'),
    (59, 'microwave'), (62, 'stove'), (63, 'shoe'),
    (64, 'computer tower'), (65, 'bottle'), (66, 'bin'),
    (67, 'ottoman'), (68, 'bench'), (69, 'board'),
    (70, 'washing machine'), (71, 'mirror'), (72, 'copier'),
    (73, 'basket'), (74, 'sofa chair'), (75, 'file cabinet'),
    (76, 'fan'), (77, 'laptop'), (78, 'shower'),
    (79, 'paper'), (80, 'person'), (82, 'paper towel dispenser'),
    (84, 'oven'), (86, 'blinds'), (87, 'rack'),
    (88, 'plate'), (89, 'blackboard'), (90, 'piano'),
    (93, 'suitcase'), (95, 'rail'), (96, 'radiator'),
    (97, 'recycling bin'), (98, 'container'), (99, 'wardrobe'),
    (100, 'soap dispenser'), (101, 'telephone'), (102, 'bucket'),
    (103, 'clock'), (104, 'stand'), (105, 'light'),
    (106, 'laundry basket'), (107, 'pipe'), (110, 'clothes dryer'),
    (112, 'guitar'), (115, 'toilet paper holder'), (116, 'seat'),
    (118, 'speaker'), (120, 'column'), (121, 'bicycle'),
    (122, 'ladder'), (125, 'bathroom stall'), (128, 'shower wall'),
    (130, 'cup'), (131, 'jacket'), (132, 'storage bin'),
    (134, 'coffee maker'), (136, 'dishwasher'), (138, 'paper towel roll'),
    (139, 'machine'), (140, 'mat'), (141, 'windowsill'),
    (145, 'bar'), (148, 'toaster'), (154, 'bulletin board'),
    (155, 'ironing board'), (156, 'fireplace'), (157, 'soap dish'),
    (159, 'kitchen counter'), (161, 'doorframe'), (163, 'toilet paper dispenser'),
    (165, 'mini fridge'), (166, 'fire extinguisher'), (168, 'ball'),
    (169, 'hat'), (170, 'shower curtain rod'), (177, 'water cooler'),
    (180, 'paper cutter'), (185, 'tray'), (188, 'shower door'),
    (191, 'pillar'), (193, 'ledge'), (195, 'toaster oven'),
    (202, 'mouse'), (208, 'toilet seat cover dispenser'), (213, 'furniture'),
    (214, 'cart'), (221, 'storage container'), (229, 'scale'),
    (230, 'tissue box'), (232, 'light switch'), (233, 'crate'),
    (242, 'power outlet'), (250, 'decoration'), (261, 'sign'),
    (264, 'projector'), (276, 'closet door'), (283, 'vacuum cleaner'),
    (286, 'candle'), (300, 'plunger'), (304, 'stuffed animal'),
    (312, 'headphones'), (323, 'dish rack'), (325, 'broom'),
    (331, 'guitar case'), (342, 'range hood'), (356, 'dustpan'),
    (370, 'hair dryer'), (392, 'water bottle'), (395, 'handicap bar'),
    (399, 'purse'), (408, 'vent'), (417, 'shower floor'),
    (488, 'water pitcher'), (540, 'mailbox'), (562, 'bowl'),
    (570, 'paper bag'), (572, 'alarm clock'), (581, 'music stand'),
    (609, 'projector screen'), (748, 'divider'), (776, 'laundry detergent'),
    (1156, 'bathroom counter'), (1163, 'object'), (1164, 'bathroom vanity'),
    (1165, 'closet wall'), (1166, 'laundry hamper'), (1167, 'bathroom stall door'),
    (1168, 'ceiling light'), (1169, 'trash bin'), (1170, 'dumbbell'),
    (1171, 'stair rail'), (1172, 'tube'), (1173, 'bathroom cabinet'),
    (1174, 'cd case'), (1175, 'closet rod'), (1176, 'coffee kettle'),
    (1178, 'structure'), (1179, 'shower head'), (1180, 'keyboard piano'),
    (1181, 'case of water bottles'), (1182, 'coat rack'), (1183, 'storage organizer'),
    (1184, 'folded chair'), (1185, 'fire alarm'), (1186, 'power strip'),
    (1187, 'calendar'), (1188, 'poster'), (1189, 'potted plant'),
    (1190, 'luggage'), (1191, 'mattress'),
)

VALID_CLASS_IDS_20 = tuple(i for i, _ in SCANNET_20)
CLASS_LABELS_20 = tuple(n for _, n in SCANNET_20)
VALID_CLASS_IDS_200 = tuple(i for i, _ in SCANNET_200)
CLASS_LABELS_200 = tuple(n for _, n in SCANNET_200)
