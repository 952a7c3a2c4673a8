"""Extract the published SEA-2022 trained weights from the reference binary.

The reference embeds its trained model as a C string constant
(reference: src/GNN_VC.cpp:23, `model_data`).  These are *data* (trained
parameters published under the reference's MIT license), which we ship as a
plain text checkpoint in the reference's own model file format.

Usage: python tools/extract_reference_weights.py
"""

import os
import re

SRC = "/root/reference/src/GNN_VC.cpp"
DST = os.path.join(
    os.path.dirname(__file__), "..", "gnn_mwvc", "models", "weights",
    "gnn_vc_sea2022.txt",
)


def main():
    with open(SRC) as f:
        for line in f:
            if "model_data" in line and '"' in line:
                break
        else:
            raise SystemExit("model_data constant not found")
    s = line[line.index('"') + 1 : line.rindex('"')]
    # Decode the C escape sequences present in the literal (only \n and \").
    s = s.replace('\\"', '"').replace("\\n", "\n")
    with open(os.path.abspath(DST), "w") as f:
        f.write(s)
    print(f"wrote {len(s)} bytes to {os.path.abspath(DST)}")


if __name__ == "__main__":
    main()
