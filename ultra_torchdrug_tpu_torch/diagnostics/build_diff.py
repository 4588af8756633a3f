"""The compiled kernels of this checkout against another's, on the card's
machine: builds every ``csrc/*.cu`` of both checkouts (ops/cuda_build.py,
one nvcc per source, all at once), prints each kernel's registers and
spilled bytes from nvcc's ``-Xptxas -v`` lines, and compares the two
checkouts' SASS (``cuobjdump -sass``) kernel by kernel, with instruction
addresses and the hashes in internal-linkage names left out. Kernels are
named as ``c++filt`` (or ``cu++filt``) demangles them, without their
parameter lists. A redesign that must leave other kernels' code as it was
shows it here: every kernel that both libraries hold should read
"identical" (``--show N`` prints the first N lines of each other kernel's
diff). Where a kernel gained a template argument, ``--rename
PATTERN=REPLACEMENT`` (a regular expression, ``re.sub``'s replacement;
repeatable) maps this checkout's name of an instantiation to the parent's,
so that the two are compared:

    python ultra_torchdrug_tpu_torch/diagnostics/build_diff.py \\
        --parent output/parent --out output/build_diff.txt \\
        --rename ', float>$=>' \\
        --rename 'rotate_seg_rows<(.*), true>$=rotate_seg_rows<\\1>'

It needs nvcc and cuobjdump (under CUDA_HOME, default /usr/local/cuda).
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def build(root: Path) -> dict:
    """Build every kernel source of the checkout at ``root`` in a process
    of its own (its package, not this one); returns source -> library."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from ultra_torchdrug_tpu_torch.ops import cuda_build as b; "
            "print('\\n'.join(f'{k} {v}' for k, v in "
            "b.build(b.sources()).items()))")
    out = subprocess.run([sys.executable, "-c", code, str(root)],
                         check=True, capture_output=True, text=True).stdout
    return dict(line.split(" ", 1) for line in out.splitlines())


def resources(log: str) -> list:
    """(kernel, registers, spilled bytes) from nvcc's ptxas lines."""
    found = re.finditer(r"Compiling entry function '([^']+)'.*?(\d+) bytes "
                        r"spill stores.*?Used (\d+) registers", log, re.S)
    return [(m.group(1), int(m.group(3)), int(m.group(2))) for m in found]


TOOLS = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"


def without_parameters(name: str) -> str:
    """A demangled function name without its trailing parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def demangle(names: list) -> list:
    """Each mangled name as c++filt (else cu++filt, which writes template
    values as casts) demangles it, without its parameter list; the names as
    they are where neither tool runs."""
    for tool in ("c++filt", str(TOOLS / "cu++filt")):
        try:
            out = subprocess.run([tool], input="\n".join(names), check=True,
                                 capture_output=True, text=True).stdout
        except (OSError, subprocess.CalledProcessError):
            continue
        return [without_parameters(line) for line in out.splitlines()]
    return names


def sass(lib: str, renames=()) -> dict:
    """Kernel name (demangled, hashes as H, then ``renames`` applied:
    (pattern, replacement) pairs) -> its SASS instructions."""
    out = subprocess.run([str(TOOLS / "cuobjdump"), "-sass", lib], check=True,
                         capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            kernels[name].append(re.sub(r"/\*[0-9a-f]*\*/", "", line)
                                 .split(";")[0].strip())
    named = {}
    for mangled, readable in zip(list(kernels), demangle(list(kernels))):
        readable = re.sub(r"[0-9a-f]{8,}", "H", readable)
        for pattern, replacement in renames:
            readable = re.sub(pattern, replacement, readable)
        named[readable] = kernels[mangled]
    return named


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout (e.g. a git archive of the "
                         "parent commit)")
    ap.add_argument("--out", help="also write the report here")
    ap.add_argument("--show", type=int, default=0, metavar="N",
                    help="print up to N lines of each differing kernel's "
                         "unified diff (the parent's SASS first)")
    ap.add_argument("--rename", action="append", default=[],
                    metavar="PATTERN=REPLACEMENT",
                    help="map this checkout's kernel names to the other's "
                         "(re.sub on the demangled name); repeatable")
    args = ap.parse_args(argv)
    renames = [tuple(r.split("=", 1)) for r in args.rename]
    ours, theirs = build(HERE), build(Path(args.parent).resolve())
    lines = []
    for name in sorted(ours):
        log = Path(ours[name]).with_suffix(".so.log").read_text()
        for kernel, regs, spill in resources(log):
            lines.append(f"[regs] {name}: {kernel}: {regs} registers, "
                         f"{spill} bytes spilled")
        if name not in theirs:
            lines.append(f"[sass] {name}: only in this checkout")
            continue
        new, old = sass(ours[name], renames), sass(theirs[name])
        both = [k for k in new if k in old]
        differ = [k for k in both if new[k] != old[k]]
        lines.append(f"[sass] {name}: {len(both) - len(differ)} of "
                     f"{len(both)} kernels in both identical; differ "
                     f"{differ}; only here {sorted(set(new) - set(old))}, "
                     f"only in the other {sorted(set(old) - set(new))}")
        for kernel in differ if args.show else ():
            diff = list(difflib.unified_diff(old[kernel], new[kernel],
                                             lineterm="", n=1))
            lines.append(f"[diff] {kernel}: {len(new[kernel])} instructions "
                         f"against {len(old[kernel])}")
            lines += [f"[diff]   {d}" for d in diff[2:2 + args.show]]
    print("\n".join(lines))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return lines


if __name__ == "__main__":
    main()
