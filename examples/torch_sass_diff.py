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
whether the change reached its code). A kernel of this tree whose
template gained a trailing parameter is compared with the other tree's
kernel named without that argument (the default's instantiation; where
several map to one, the closest in code), and reported as ``pairs``. For
every kernel that differs, ``differences`` gives each tree's instruction
count, the instructions a diff changes, and the same with register
numbers, predicates and immediates left out (what changed beyond the
register allocation), the first changed instruction's index, the last
HGMMA's (the wgmma products), whether the HGMMA instructions (their
opcodes and shapes, in order) are the same in both, and each tree's
registers; ``registers`` lists every kernel's and ``wgmma_warnings``
ptxas's C7510-C7515 lines. Use
it to show that a change to a shared kernel source leaves the
instantiations it did not mean to touch compiled to the same code, or
where it touched them. Writes the ptxas logs and the disassembly under
``--out``.

Needs nvcc and cuobjdump (the CUDA toolkit), not a GPU; imports nothing of
jax or paddle_tpu.
"""

import argparse
import difflib
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
# a normalised name's last template argument
LAST_ARG = re.compile(r"L[a-z]+n?\d+E(E)$")
# operands that name registers, predicates, barriers or constants
OPERANDS = re.compile(r"\b(?:U?R|U?P|B)\d+\b|\b0x[0-9a-f]+\b|\b\d+\b")


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


def changed(a, b):
    """(instructions a diff of a and b changes, the first one's index)."""
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    n = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops
            if tag != "equal")
    return n, next((i1 for tag, i1, _, _, _ in ops if tag != "equal"), None)


def difference(a, b):
    """How two instruction lists differ: counts, changed instructions (as
    they are, and with their operands' numbers left out), the first
    change's index and the last HGMMA's (in `a`), and whether the HGMMA
    opcodes are the same, in order."""
    n, first = changed(a, b)
    bare = lambda xs: [OPERANDS.sub("#", x) for x in xs]
    n_bare, first_bare = changed(bare(a), bare(b))
    hg = lambda xs: [x.split()[0] for x in xs if "HGMMA" in x]
    last_hg = max((i for i, x in enumerate(a) if "HGMMA" in x), default=None)
    return {"instructions": [len(a), len(b)], "changed": n,
            "first_change_at": first, "changed_bare": n_bare,
            "first_bare_change_at": first_bare, "last_hgmma_at": last_hg,
            "hgmma_same": hg(a) == hg(b)}


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


def registers(log: str):
    """{kernel (normalised): the registers ptxas reports it uses}."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = normalise(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            found[name] = int(m.group(1))
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
    code, spilled, regs, warned = {}, {}, {}, {}
    for tag in trees:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(out / f"{a.source}.{tag}.cubin")],
            check=True, capture_output=True, text=True).stdout
        (out / f"{a.source}.{tag}.sass").write_text(sass)
        code[tag] = kernels(sass)
        log = (out / f"{a.source}.{tag}.ptxas.txt").read_text()
        spilled[tag], regs[tag] = spills(log), registers(log)
        # ptxas's wgmma serialisation warnings (C7510-C7515)
        warned[tag] = [ln.strip() for ln in log.splitlines()
                       if re.search(r"C751\d", ln)]
    # a template parameter added at the end: this tree's kernel against
    # the other's without that argument
    cands = {}
    for n in sorted(set(code["this"]) - set(code["other"])):
        m = n if LAST_ARG.search(n) is None else LAST_ARG.sub(r"\1", n)
        if m != n and m in code["other"] and m not in code["this"]:
            cands.setdefault(m, []).append(n)
    pairs = {min(ns, key=lambda n: changed(code["this"][n],
                                           code["other"][m])[0]): m
             for m, ns in cands.items()}
    names = sorted((set(code["this"]) | set(code["other"]))
                   - set(pairs.values()))
    verdict, detail = {}, {}
    for n in names:
        a_ = code["this"].get(n)
        b_ = code["other"].get(pairs.get(n, n))
        verdict[n] = ("this tree only" if b_ is None else
                      "other tree only" if a_ is None else
                      "same" if a_ == b_ else "different")
        if verdict[n] == "different":
            detail[n] = dict(difference(a_, b_), registers=[
                regs["this"].get(n), regs["other"].get(pairs.get(n, n))])
    print(json.dumps({"source": a.source, "other": str(trees["other"]),
                      "kernels": verdict, "pairs": pairs,
                      "same": sum(v == "same" for v in verdict.values()),
                      "different": sum(v == "different"
                                       for v in verdict.values()),
                      "differences": detail, "spills": spilled,
                      "registers": regs, "wgmma_warnings": warned}),
          flush=True)


if __name__ == "__main__":
    main()
