"""Class-name <-> id taxonomies for ActEV/DIVA and COCO.

Capability parity with reference class_ids.py (tables are shared data, the
ActEV/DIVA and COCO label vocabularies; reference: class_ids.py:39-558).
"""

# ActEV/DIVA v1 object classes ("diva_class3" in the reference).
targetClass2id = {
    "BG": 0,
    "Vehicle": 1,
    "Person": 2,
    "Parking_Meter": 3,
    "Tree": 4,
    "Other": 5,
    "Trees": 6,
    "Construction_Barrier": 7,
    "Door": 8,
    "Dumpster": 9,
    "Push_Pulled_Object": 10,
    "Construction_Vehicle": 11,
    "Prop": 12,
    "Bike": 13,
    "Animal": 14,
    "Articulated_Infrastructure": 15,
}

targetid2class = {v: k for k, v in targetClass2id.items()}

# DIVA classes with the merged Prop+PPO class (reference "mergeProp").
targetClass2id_mergeProp = dict(
    targetClass2id, **{"Prop_plus_Push_Pulled_Object": 16})

# DIVA "new" taxonomy with person-object composite classes.
targetClass2id_new = {
    "BG": 0,
    "Vehicle": 1,
    "Person": 2,
    "Parking_Meter": 3,
    "Tree": 4,
    "Skateboard": 5,
    "Prop_Overshoulder": 6,
    "Construction_Barrier": 7,
    "Door": 8,
    "Dumpster": 9,
    "Push_Pulled_Object": 10,
    "Construction_Vehicle": 11,
    "Prop": 12,
    "Bike": 13,
    "Animal": 14,
    "Bike_Person": 15,
    "Prop_Person": 16,
    "Skateboard_Person": 17,
    "Prop_Overshoulder_Person": 18,
}

targetClass2id_new_nopo = {
    k: v for k, v in targetClass2id_new.items() if v <= 14}

# Activity-box taxonomy (ACTIVITY_BOX.md experiments).
targetAct2id = {
    "BG": 0,
    "activity_walking": 1,
    "vehicle_moving": 2,
    "activity_standing": 3,
    "vehicle_stopping": 4,
    "activity_carrying": 5,
    "vehicle_starting": 6,
    "vehicle_turning_right": 7,
    "vehicle_turning_left": 8,
    "activity_gesturing": 9,
    "Closing": 10,
    "Opening": 11,
    "Interacts": 12,
    "Exiting": 13,
    "Entering": 14,
    "Talking": 15,
    "Transport_HeavyCarry": 16,
    "Unloading": 17,
    "Pull": 18,
    "Loading": 19,
    "Open_Trunk": 20,
    "Closing_Trunk": 21,
    "Riding": 22,
    "specialized_texting_phone": 23,
    "Person_Person_Interaction": 24,
    "specialized_talking_phone": 25,
    "activity_running": 26,
    "PickUp": 27,
    "specialized_using_tool": 28,
    "SetDown": 29,
    "activity_crouching": 30,
    "activity_sitting": 31,
    "Object_Transfer": 32,
    "Push": 33,
    "PickUp_Person_Vehicle": 34,
}

# The 80 COCO thing classes, standard order, with BG at index 0 (81 classes).
coco_obj_classes = [
    "BG",
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

coco_obj_class_to_id = {c: i for i, c in enumerate(coco_obj_classes)}
coco_obj_id_to_class = {i: c for i, c in enumerate(coco_obj_classes)}

# Sparse original 90-id COCO mapping (used by EfficientDet checkpoints).
coco_id_mapping = {
    1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
    6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
    11: "fire hydrant", 13: "stop sign", 14: "parking meter", 15: "bench",
    16: "bird", 17: "cat", 18: "dog", 19: "horse", 20: "sheep", 21: "cow",
    22: "elephant", 23: "bear", 24: "zebra", 25: "giraffe", 27: "backpack",
    28: "umbrella", 31: "handbag", 32: "tie", 33: "suitcase", 34: "frisbee",
    35: "skis", 36: "snowboard", 37: "sports ball", 38: "kite",
    39: "baseball bat", 40: "baseball glove", 41: "skateboard",
    42: "surfboard", 43: "tennis racket", 44: "bottle", 46: "wine glass",
    47: "cup", 48: "fork", 49: "knife", 50: "spoon", 51: "bowl", 52: "banana",
    53: "apple", 54: "sandwich", 55: "orange", 56: "broccoli", 57: "carrot",
    58: "hot dog", 59: "pizza", 60: "donut", 61: "cake", 62: "chair",
    63: "couch", 64: "potted plant", 65: "bed", 67: "dining table",
    70: "toilet", 72: "tv", 73: "laptop", 74: "mouse", 75: "remote",
    76: "keyboard", 77: "cell phone", 78: "microwave", 79: "oven",
    80: "toaster", 81: "sink", 82: "refrigerator", 84: "book", 85: "clock",
    86: "vase", 87: "scissors", 88: "teddy bear", 89: "hair drier",
    90: "toothbrush",
}

# COCO class -> ActEV class used for partial-class inference with COCO models.
coco_obj_to_actev_obj = {
    "person": "Person",
    "car": "Vehicle",
    "bus": "Vehicle",
    "truck": "Vehicle",
    "bicycle": "Bike",
}


# BUPT-MCPRL experiment activity taxonomy (ref class_ids.py:361-389):
# grouped Person-Vehicle / Vehicle-Turning super-classes + 8 singles.
targetAct2id_bupt = {
    "BG": 0,
    "Person-Vehicle": 1,
    "Vehicle-Turning": 2,
    "activity_carrying": 3,
    "Transport_HeavyCarry": 4,
    "Talking": 5,
    "Pull": 6,
    "Riding": 7,
    "specialized_texting_phone": 8,
    "specialized_talking_phone": 9,
}

bupt_act_mapping = {
    "Closing": "Person-Vehicle",
    "Opening": "Person-Vehicle",
    "Exiting": "Person-Vehicle",
    "Entering": "Person-Vehicle",
    "Unloading": "Person-Vehicle",
    "Loading": "Person-Vehicle",
    "Open_Trunk": "Person-Vehicle",
    "Closing_Trunk": "Person-Vehicle",
    "vehicle_turning_right": "Vehicle-Turning",
    "vehicle_turning_left": "Vehicle-Turning",
    "vehicle_u_turn": "Vehicle-Turning",
}

# MEVA dataset activity taxonomy (ref class_ids.py:391-438).
targetAct2id_meva = {
    "BG": 0,
    "Person-Vehicle": 1,
    "Person-Structure": 2,
    "Vehicle-Turning": 3,
    "Person_Heavy_Carry": 4,
    "People_Talking": 5,
    "Riding": 6,
    "Person_Texting_on_Phone": 7,
    "Person_Talking_on_Phone": 8,
    "Person_Sitting_Down": 9,
    "Person_Sets_Down_Object": 10,
    "Person_Standing_Up": 11,
    "Person_Picks_Up_Object": 12,
    "Person_Purchasing": 13,
    "Person_Reading_Document": 14,
    "Object_Transfer": 15,
    "Hand_Interaction": 16,
    "Person-Person_Embrace": 17,
    "Person-Laptop_Interaction": 18,
    "Vehicle_Stopping": 19,
    "Vehicle_Starting": 20,
    "Vehicle_Reversing": 21,
}

meva_act_mapping = {
    "Person_Exits_Vehicle": "Person-Vehicle",
    "Person_Enters_Vehicle": "Person-Vehicle",
    "Person_Opens_Vehicle_Door": "Person-Vehicle",
    "Person_Closes_Vehicle_Door": "Person-Vehicle",
    "Vehicle_Drops_Off_Person": "Person-Vehicle",
    "Person_Unloads_Vehicle": "Person-Vehicle",
    "Person_Loads_Vehicle": "Person-Vehicle",
    "Person_Opens_Trunk": "Person-Vehicle",
    "Person_Closes_Trunk": "Person-Vehicle",
    "Vehicle_Picks_Up_Person": "Person-Vehicle",
    "Vehicle_Turning_Right": "Vehicle-Turning",
    "Vehicle_Turning_Left": "Vehicle-Turning",
    "Vehicle_U-Turn": "Vehicle-Turning",
    "Person_Enters_Through_Structure": "Person-Structure",
    "Person_Exits_Through_Structure": "Person-Structure",
    "Person_Opens_Facility_Door": "Person-Structure",
    "Person_Closes_Facility_Door": "Person-Structure",
}
