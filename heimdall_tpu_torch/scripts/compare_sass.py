"""Build csrc sources of this tree and of another checkout with nvcc and
compare the SASS of named kernels instruction for instruction; also write
each build's ptxas report (registers, shared memory, spills).

    python -m heimdall_tpu_torch.scripts.compare_sass OTHER_ROOT \\
        [--sources fused_detect,...] [--kernels k_preprocess,...] \\
        [--out DIR]

OTHER_ROOT is the root of another checkout (e.g. a `git archive` of the
parent commit).  Each source is built in both trees with ops/_cuda.py's
flags and -Xptxas -v, then `cuobjdump -sass` lists every function; a
function of either build whose name holds one of the kernels' names is
compared with the function of the same name in the other build (the
anonymous namespace's hash taken out), its instructions with their
addresses and encodings stripped.  Prints one JSON line {source:
{function: {"equal", "instructions"}}} and exits 1 where a function
differs or is missing from one build.  Needs nvcc and cuobjdump
(the CUDA toolkit); no card.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from heimdall_tpu_torch.ops import _cuda

_FUNC = re.compile(r"^\s*Function : (\S+)")
# the anonymous namespace's mangled name holds a hash of the build
_ANON = re.compile(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*(/\*.*\*/)?\s*$")


def build(root: Path, name: str, out_dir: Path, tag: str) -> Path:
    """nvcc of root/heimdall_tpu_torch/csrc/<name>.cu; the ptxas report
    goes to out_dir/<tag>_<name>.ptxas.txt."""
    so = out_dir / f"{tag}_{name}.so"
    src = root / "heimdall_tpu_torch" / "csrc" / f"{name}.cu"
    proc = subprocess.run(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(so), str(src)], capture_output=True, text=True)
    (out_dir / f"{tag}_{name}.ptxas.txt").write_text(proc.stdout +
                                                     proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return so


def functions(so: Path) -> dict:
    """{function name: [instruction, ...]} of cuobjdump -sass."""
    cuobjdump = os.path.join(os.path.dirname(_cuda.nvcc_path()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(_ANON.sub("_GLOBAL__N_", m.group(1)), [])
            continue
        m = _INSN.match(line)
        if cur is not None and m and m.group(1):
            cur.append(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root")
    ap.add_argument("--sources", default="fused_detect")
    ap.add_argument("--kernels", default="k_preprocess")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parents[2]
    other = Path(args.other_root).resolve()
    kernels = args.kernels.split(",")
    result, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(args.out) if args.out else Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in args.sources.split(","):
            mine = functions(build(here, name, out_dir, "this"))
            theirs = functions(build(other, name, out_dir, "other"))
            names = sorted(n for n in set(mine) | set(theirs)
                           if any(k in n for k in kernels))
            result[name] = {}
            for fn in names:
                a, b = mine.get(fn), theirs.get(fn)
                equal = a is not None and a == b
                ok &= equal
                result[name][fn] = {
                    "equal": equal,
                    "instructions": [len(a or []), len(b or [])]}
            ok &= bool(names)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
