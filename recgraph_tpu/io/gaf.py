"""GAF line model.

Mirrors the reference's GAFStruct (reference: src/gaf_output.rs:6-94):
12 standard GAF columns plus a free-text comment column; the path column
is serialised as ``>id>id>...`` with a leading '>'.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GafRecord:
    query_name: str = ""
    query_length: int = 0
    query_start: int = 0
    query_end: int = 0
    strand: str = " "
    path: list[int] = field(default_factory=lambda: [0])
    path_length: int = 0
    path_start: int = 0
    path_end: int = 0
    residue_matches_number: int = 0
    alignment_block_length: str = ""
    mapping_quality: str = ""
    comments: str = ""

    def to_string(self) -> str:
        path_matching = ">".join(str(i) for i in self.path)
        return "\t".join(
            [
                self.query_name,
                str(self.query_length),
                str(self.query_start),
                str(self.query_end),
                self.strand,
                ">" + path_matching,
                str(self.path_length),
                str(self.path_start),
                str(self.path_end),
                str(self.residue_matches_number),
                self.alignment_block_length,
                self.mapping_quality,
                self.comments,
            ]
        )


class GafWriter:
    """stdout-or-file GAF sink.

    Mirrors utils::write_gaf (reference: src/utils.rs:200-219): with an
    out-file, the file is truncated when ``number == 1`` (or when it does
    not yet exist) and appended otherwise.  Modes 0-3 pass 1-based read
    numbers, modes 4-9 pass 0-based ones (main.rs:98-103 vs :260,268,311)
    — we preserve that calling convention at the CLI layer.
    """

    def __init__(self, out_file: str = "standard output", number_offset: int = 0):
        self.out_file = out_file
        self.number_offset = number_offset  # resume-at-offset support
        self._created = False

    def write(self, gaf_line: str, number: int) -> None:
        number += self.number_offset
        if self.out_file == "standard output":
            print(gaf_line)
            return
        import os

        exists = os.path.exists(self.out_file)
        mode = "a" if (exists and number != 1) else "w"
        with open(self.out_file, mode) as fh:
            fh.write(gaf_line + "\n")
