"""AudioSet metadata: ontology + segment CSV parsing.

A copy of ``audio_tokens_tpu/data/metadata.py``, held equal to the original by
``tests/test_torch_train_data.py``.

Behavioral equivalent of the reference's AudiosetMetadataProcessor
(reference: processors/audioset_metadata_processor.py:11-85):

  * ontology JSON entries with an empty ``restrictions`` list get dense label
    indices 0..N-1 in file order (543 of 632 for the shipped AudioSet
    ontology; reference :30-43);
  * segment CSVs skip 3 header rows; column 0 is the ytid, column 3 the
    comma-joined label-id string; unknown (restricted) labels are dropped
    (reference :45-67).

The parse is pure host-side python — kept dependency-free and cached, since
at the 2M-clip unbalanced scale the CSV parse happens once per run.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Dict, List

from audio_tokens_tpu_torch.config import AudioTokensConfig
from audio_tokens_tpu_torch.utils.seeding import set_seed


def load_class_names(config: AudioTokensConfig) -> List[str]:
    """index -> label-name list from the ontology JSON alone (no segment
    CSVs, no RNG side effects) — same dense-index filter (_load_ontology)
    as the full processor.  For consumers that only need names, e.g. the
    serving-export manifest."""
    with Path(config.ontology_json_file).open("r") as f:
        ontology = json.load(f)
    names = [item["name"] for item in ontology if not item["restrictions"]]
    names = names[: config.num_classes]
    names += [""] * (config.num_classes - len(names))
    return names


class AudiosetMetadataProcessor:
    def __init__(self, config: AudioTokensConfig):
        self.config = config
        set_seed(self.config.random_seed)
        self.logger = logging.getLogger(__name__)
        self.label_index: Dict[str, int] = {}
        self.index_label: Dict[int, str] = {}
        self.label_name: Dict[str, str] = {}
        self.ytid_labels: Dict[str, List[int]] = {}
        self._load_ontology()
        self._load_segment_data()

    def _load_ontology(self) -> None:
        with Path(self.config.ontology_json_file).open("r") as f:
            ontology = json.load(f)
        index = 0
        for item in ontology:
            if not item["restrictions"]:
                self.index_label[index] = item["id"]
                self.label_index[item["id"]] = index
                self.label_name[item["id"]] = item["name"]
                index += 1
        self.logger.info("Loaded %d non-restricted classes", index)

    def _load_segment_data(self) -> None:
        for csv_file in self.config.csv_index_files:
            with open(csv_file, "r") as f:
                reader = csv.reader(f, skipinitialspace=True)
                for _ in range(3):  # header comment rows
                    if next(reader, None) is None:
                        raise ValueError(
                            f"segment CSV {csv_file} is truncated "
                            "(expected 3 header rows)")
                for row in reader:
                    if len(row) < 4:  # blank/short line: skip, don't crash
                        continue
                    ytid, label_str = row[0], row[3]
                    self.ytid_labels[ytid] = [
                        self.label_index[lab]
                        for lab in label_str.split(",")
                        if lab in self.label_index
                    ]
            self.logger.info(
                "Loaded segment data for %d YouTube IDs", len(self.ytid_labels)
            )
        if self.ytid_labels:
            counts = [len(v) for v in self.ytid_labels.values()]
            self.logger.info(
                "labels/ytid avg=%.2f max=%d min=%d; %d ytids unlabeled",
                sum(counts) / len(counts),
                max(counts),
                min(counts),
                sum(1 for c in counts if c == 0),
            )

    @property
    def num_classes(self) -> int:
        return len(self.label_index)

    def get_all_ytids(self) -> List[str]:
        return list(self.ytid_labels.keys())

    def get_ytid_labels(self, ytid: str) -> List[int]:
        return self.ytid_labels.get(ytid, [])

    def multi_hot(self, ytid: str, num_classes: int):
        """Dense multi-hot float vector for a clip's labels."""
        import numpy as np

        vec = np.zeros(num_classes, dtype=np.float32)
        # load_class_names supports num_classes BELOW the ontology's class
        # count (truncation); labels past the truncated range drop out of
        # the vector instead of raising IndexError
        idxs = [i for i in self.ytid_labels.get(ytid, []) if i < num_classes]
        if idxs:
            vec[np.asarray(idxs)] = 1.0
        return vec
