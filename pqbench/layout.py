#!/usr/bin/env python3
"""Print the layout the program's writer gives a configuration's file
(``pinned_layout``'s form), for pinning it in the configuration file.

    python3 pqbench/layout.py <configuration file> --seed <n>
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pqbench import tables, write  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    with open(args.config) as f:
        config = json.load(f)
    groups = tables.load(config["table"]).draw(args.seed, config)
    with tempfile.TemporaryDirectory(prefix="pqbench-") as tmp:
        path = os.path.join(tmp, "layout.parquet")
        write.write_file(config, groups, path)
        got = write.file_layout(path)
        size = os.path.getsize(path)
    print(json.dumps({"bytes": size,
                      "row_group_rows": got["row_group_rows"],
                      "chunk_encodings": got["chunk_encodings"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
