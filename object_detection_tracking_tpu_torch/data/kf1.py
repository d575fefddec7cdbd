"""MEVA / KF1 Kitware annotation ingest.

Parity surface: reference diva_io/annotation/kf1.py:1 (KitwareAnnotation)
and diva_io/annotation/converter.py:30 (Kitware YAML -> ActEV Scorer
official JSON). A MEVA clip's annotations are three YAML files next to
each other under ``<annotation_dir>/<date>/<hour>/``:

    <video_name>.activities.yml   one document per activity
    <video_name>.geom.yml         one document per (actor, frame) box
    <video_name>.types.yml        one document per actor: its class

Each file starts with any number of ``meta`` documents. The video name
encodes the search path: ``<date>.<start>.<end>.<loc>.<cam>`` — the hour
directory is ``start[:2]`` (falling back to ``end[:2]``, some clips
straddle the hour boundary).

Output matches the official ActEV reference format the scorer consumes
(the reference emits objectType "Vehicle" for every actor regardless of
its cset3 class — the scorer ignores the field; we preserve that quirk
for byte-parity, the true class is kept on ``Actor.kind``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

try:
    import yaml
    HAVE_YAML = True
except ImportError:  # pragma: no cover - yaml is in this image
    yaml = None
    HAVE_YAML = False


@dataclass
class Actor:
    """One annotated object: its class and per-frame boxes (x1y1x2y2)."""
    actor_id: int
    kind: str = ""
    boxes: Dict[int, Tuple[int, int, int, int]] = field(default_factory=dict)


@dataclass
class Activity:
    """One annotated activity instance over a span of frames."""
    activity_id: int
    kind: str
    start: int
    end: int
    actors: List[Tuple[int, List[Tuple[int, int]]]]  # (actor_id, spans)


class KF1Annotation:
    """Parsed Kitware KF1 annotation triplet for one video clip."""

    def __init__(self, video_name: str, annotation_dir: str):
        if not HAVE_YAML:
            raise ImportError("pyyaml is required for KF1 annotations")
        self.video_name = video_name
        docs = {f: self._read_yaml(annotation_dir, f)
                for f in ("geom", "types", "activities")}
        self.meta = {f: m for f, (m, _) in docs.items()}
        self.actors = self._parse_actors(docs["geom"][1], docs["types"][1])
        self.activities = self._parse_activities(docs["activities"][1])

    # -- parsing -------------------------------------------------------

    def _read_yaml(self, annotation_dir: str, field_name: str):
        """Locate and split one of the three YAML files into
        (meta_documents, payload_documents)."""
        date, t_start, t_end = self.video_name.split(".")[:3]
        fname = f"{self.video_name}.{field_name}.yml"
        tried = []
        for hour in (t_start[:2], t_end[:2]):
            path = os.path.join(annotation_dir, date, hour, fname)
            tried.append(path)
            if os.path.exists(path):
                with open(path) as f:
                    docs = yaml.safe_load(f)
                break
        else:
            raise FileNotFoundError(" | ".join(tried))
        key = "act" if field_name == "activities" else field_name
        meta = []
        payload = []
        for doc in docs or []:
            if key in doc:
                payload.append(doc[key])
            elif "meta" in doc:
                meta.append(doc["meta"])
        return meta, payload

    @staticmethod
    def _parse_actors(geoms, types) -> Dict[int, Actor]:
        actors: Dict[int, Actor] = {}

        def actor(aid: int) -> Actor:
            if aid not in actors:
                actors[aid] = Actor(aid)
            return actors[aid]

        for g in geoms:
            x1, y1, x2, y2 = (int(v) for v in str(g["g0"]).split())
            actor(int(g["id1"])).boxes[int(g["ts0"])] = (x1, y1, x2, y2)
        for t in types:
            cset = t.get("cset3") or {}
            if cset:
                actor(int(t["id1"])).kind = next(iter(cset))
        return actors

    @staticmethod
    def _parse_activities(acts) -> List[Activity]:
        out = []
        for a in acts:
            kind = next(iter(a["act2"]))
            if kind.startswith("empty"):
                continue
            start, end = a["timespan"][0]["tsr0"]
            actors = []
            for actor in a.get("actors", []):
                spans = [tuple(ts["tsr0"]) for ts in actor["timespan"]]
                actors.append((int(actor["id1"]), spans))
            out.append(Activity(int(a["id2"]), kind, int(start), int(end),
                                actors))
        return out

    # -- official (ActEV Scorer) format --------------------------------

    def get_activities_official(self) -> List[dict]:
        """Official-format activity list (reference kf1.py:66-97)."""
        video = self.video_name
        out = []
        for act in self.activities:
            objects = []
            for actor_id, spans in act.actors:
                boxes = self.actors[actor_id].boxes
                history: Dict[int, dict] = {}
                for s, e in spans:
                    for frame in range(s, e + 1):
                        box = boxes.get(frame)
                        if box is None:
                            continue
                        x1, y1, x2, y2 = box
                        history[frame] = {
                            "presenceConf": 1,
                            "boundingBox": {
                                "x": min(x1, x2), "y": min(y1, y2),
                                "w": abs(x2 - x1), "h": abs(y2 - y1)}}
                for frame in range(act.start, act.end + 1):
                    history.setdefault(frame, {})
                objects.append({
                    "objectType": "Vehicle",  # scorer ignores it (see top)
                    "objectID": actor_id,
                    "localization": {video: history}})
            out.append({
                "activity": act.kind,
                "activityID": act.activity_id,
                "presenceConf": 1,
                "alertFrame": act.start,
                "localization": {video: {act.start: 1, act.end + 1: 0}},
                "objects": objects})
        return out


def list_annotated_clips(annotation_dir: str) -> List[str]:
    """Video list from the MEVA repo's index file (two header lines)."""
    path = os.path.join(annotation_dir, "list-of-annotated-meva-clips.txt")
    with open(path) as f:
        return [line.strip() for line in f if line.strip()][2:]


def convert_kf1(annotation_dir: str, output_dir: str,
                video_list: Optional[Sequence[str]] = None,
                framerate: float = 30.0) -> Dict[str, str]:
    """Kitware YAML -> ActEV Scorer reference + file-index JSONs
    (reference converter.py:48-51). Returns {name: written path}."""
    if video_list is None:
        video_list = list_annotated_clips(annotation_dir)
    activities = []
    for video_name in video_list:
        ann = KF1Annotation(video_name, annotation_dir)
        activities.extend(ann.get_activities_official())
    payload = {
        "reference": {"filesProcessed": list(video_list),
                      "activities": activities},
        "file-index": {v: {"framerate": framerate,
                           "selected": {0: 1, 9000: 0}}
                       for v in video_list},
    }
    os.makedirs(output_dir, exist_ok=True)
    written = {}
    for name, data in payload.items():
        path = os.path.join(output_dir, name + ".json")
        with open(path, "w") as f:
            json.dump(data, f)
        written[name] = path
    return written
