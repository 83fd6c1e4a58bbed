"""MetadataWriter — machine-readable run metadata
(shared/MetadataWriter.java:20): host, version, command line, reads/bases
in/out, as TSV or JSON."""

from __future__ import annotations

import json
import socket
import sys
import time


def write_metadata(path: str, reads_in=0, bases_in=0, reads_out=0,
                   bases_out=0, fmt: str = "tsv"):
    data = {
        "program": "bbtools_torch",
        "version": "0.1.0",
        "host": socket.gethostname(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "command": " ".join(sys.argv),
        "readsIn": reads_in,
        "basesIn": bases_in,
        "readsOut": reads_out,
        "basesOut": bases_out,
    }
    with open(path, "w") as fh:
        if fmt == "json" or path.endswith(".json"):
            json.dump(data, fh, indent=1)
            fh.write("\n")
        else:
            for k, v in data.items():
                fh.write(f"{k}\t{v}\n")
    return data
