"""Write a configuration file of the benchmark from a yaml of the
repository and KEY VALUE overrides: the program's whole configuration,
resolved, so that the file alone holds the configuration as it is run.

    python3 benchmark/tools/make_config.py OUT.json YAML [KEY VALUE ...]

The other keys of an existing OUT.json (``source``, ``reduced``,
``assumed``, ...) are kept; ``cfg`` is rewritten.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def plain(node):
    if isinstance(node, dict):
        return {k: plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return [plain(v) for v in node]
    return node


def main(argv):
    from centermask2_tpu_torch.config import get_cfg

    out, yaml_path, opts = argv[0], argv[1], argv[2:]
    cfg = get_cfg()
    cfg.merge_from_file(yaml_path)
    cfg.merge_from_list(opts)
    conf = {}
    if os.path.exists(out):
        with open(out) as f:
            conf = json.load(f)
    conf["cfg"] = plain(cfg)
    with open(out, "w") as f:
        json.dump(conf, f, indent=1, sort_keys=False)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
