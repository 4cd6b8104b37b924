"""Compare one kernel source's machine code between two trees.

    python3 examples/torch_sass_diff.py --other _parent \\
        [--source flash_attention_bwd] [--out DIR]

Compiles ``paddle_tpu_torch/csrc/<source>.cu`` of this tree and of the tree
at ``--other`` (an unpacked ``git archive`` of another commit) with the
package's own nvcc flags (``ops._build``: sm_90a, -O3, -lineinfo) and
``-Xptxas -v`` into cubins, disassembles both with ``cuobjdump -sass``, and
prints one JSON line: for every kernel instantiation whether its SASS is
the same in both trees (instruction text, addresses, runs of spaces and
the anonymous namespace's hash left out), present in one tree only, or
different, and each tree's ptxas lines that report spilled bytes. Kernels
are matched by mangled name with the names of the ``am`` namespace's
argument types and a template instantiation's parameter list left out, so
that a kernel whose argument struct was renamed, or whose parameters
changed, is still compared with its counterpart (its instructions then say
whether the change reached its code). Use it to show that a
change to a shared kernel source leaves the instantiations it did not mean
to touch compiled to the same code. Writes the ptxas logs and the
disassembly under ``--out``.

Needs nvcc and cuobjdump (the CUDA toolkit), not a GPU; imports nothing of
jax or paddle_tpu.
"""

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.ops import _build  # noqa: E402

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
# a type of the am namespace in a mangled name: N2am, its name's length
# and the name, E
AM_TYPE = re.compile(r"N2am(\d+)")
ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
# a template instantiation's name up to its template arguments (literal
# ints and bools, I...E), the nested name's E and the void return type v:
# what follows is the parameter list
TEMPLATE = re.compile(r"^(.*?I(?:L[a-z]+n?\d+E)+E)E?v.*$")


def compile_cubin(src: Path, cubin: Path, log: Path):
    """nvcc with the package's flags into a cubin; ptxas -v into `log`."""
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-lineinfo", "-Xptxas=-v", "-cubin", "-o", str(cubin), str(src)]
    return subprocess.Popen(cmd, stdout=log.open("w"),
                            stderr=subprocess.STDOUT)


def normalise(name: str) -> str:
    """A mangled kernel name with the anonymous namespace's hash, the names
    of am:: types and a template instantiation's parameters left out."""
    name = ANON.sub("ANON", name)
    out, at = [], 0
    for m in AM_TYPE.finditer(name):
        if m.start() < at:
            continue
        end = m.end() + int(m.group(1))
        if name[end:end + 1] != "E":
            continue
        out.append(name[at:m.start()] + "N2amE")
        at = end + 1
    return TEMPLATE.sub(r"\1", "".join(out) + name[at:])


def kernels(sass: str):
    """{kernel name (normalised): [instructions]}."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = out.setdefault(normalise(m.group(1)), [])
        elif cur is not None:
            # runs of spaces vary with the widest line of the listing
            ins = " ".join(ADDR.sub("", line).split())
            if ins:
                cur.append(ins)
    return out


def spills(log: str):
    """(kernel, ptxas's stack/spill line) where it reports spilled bytes."""
    found, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = normalise(m.group(1))
        elif "spill stores" in line and " 0 bytes spill stores" not in line:
            found.append([name, line.strip()])
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (an unpacked git archive)")
    ap.add_argument("--source", default="flash_attention_bwd")
    ap.add_argument("--out", default="chiprun_out")
    a = ap.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = {"this": ROOT, "other": Path(a.other).resolve()}
    jobs = {}
    for tag, root in trees.items():
        src = root / "paddle_tpu_torch" / "csrc" / f"{a.source}.cu"
        jobs[tag] = compile_cubin(src, out / f"{a.source}.{tag}.cubin",
                                  out / f"{a.source}.{tag}.ptxas.txt")
    for tag, p in jobs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {tag} tree: see "
                               f"{out}/{a.source}.{tag}.ptxas.txt")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    code, spilled = {}, {}
    for tag in trees:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(out / f"{a.source}.{tag}.cubin")],
            check=True, capture_output=True, text=True).stdout
        (out / f"{a.source}.{tag}.sass").write_text(sass)
        code[tag] = kernels(sass)
        spilled[tag] = spills(
            (out / f"{a.source}.{tag}.ptxas.txt").read_text())
    names = sorted(set(code["this"]) | set(code["other"]))
    verdict = {}
    for n in names:
        a_, b_ = code["this"].get(n), code["other"].get(n)
        verdict[n] = ("this tree only" if b_ is None else
                      "other tree only" if a_ is None else
                      "same" if a_ == b_ else "different")
    print(json.dumps({"source": a.source, "other": str(trees["other"]),
                      "kernels": verdict,
                      "same": sum(v == "same" for v in verdict.values()),
                      "different": sum(v == "different"
                                       for v in verdict.values()),
                      "spills": spilled}), flush=True)


if __name__ == "__main__":
    main()
