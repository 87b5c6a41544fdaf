"""Compare the compiled code of kernels between two trees on a machine with
``nvcc`` and ``cuobjdump`` (the CUDA toolkit under /usr/local/cuda).

    python3 tools/compare_sass_torch.py OLD_TREE [NEW_TREE] [--kernels a,b]

Each tree is a checkout of this repository (NEW_TREE defaults to the one
that holds this script); the kernels default to K1 and K3 (``cmux_step``,
``blind_rotate_chunk``).  Each tree builds its own libraries in a process
of its own (``nufhe_tpu_torch/kernels/build.py``, every kernel of the tree
at once, into the tree's ``_build/``); then, for each kernel, the
``cuobjdump -sass`` body of every function (its header line, which holds
the mangled name, left out) is compared as a multiset between the trees,
and both trees' ``ptxas`` register and spill lines are printed.  Exits 1
if any kernel's code differs.  A template argument added with a default
changes the mangled names but not the code, which is what this compares.
Where a kernel's multisets differ, each function is also compared on its
own by its mangled name (one template instantiation; the Variant is
``blind_rotate_kernel``'s last template argument), to show which ones
changed when both trees have the same templates.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def build(tree, names):
    """Build ``names`` in ``tree``; returns {name: library path}."""
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from nufhe_tpu_torch.kernels import build\n"
            "build.build_all()\n"
            "for n in %r: build.entry(n)\n"
            "print(json.dumps({n: str(build._library_path(n)[1]) "
            "for n in %r}))" % (tree, names, names))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tree, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def bodies(lib):
    """{function header: SASS body} of a shared library; the header is the
    mangled name without the per-build hash of its anonymous namespace, the
    body has each run of blanks as one (``cuobjdump`` pads its columns to a
    width that the library's other functions can change)."""
    sass = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__",
                   name.strip())] = re.sub(r"[ \t]+", " ", body)
    return out


def ptxas_lines(tree, name):
    log = os.path.join(tree, "nufhe_tpu_torch", "kernels", "_build",
                       "%s.log" % name)
    return [line.strip() for line in open(log).read().splitlines()
            if "registers" in line or "spill" in line]


def main(argv):
    names = ["cmux_step", "blind_rotate_chunk"]
    if "--kernels" in argv:
        i = argv.index("--kernels")
        names = argv[i + 1].split(",")
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        raise SystemExit(__doc__)
    old = os.path.abspath(argv[0])
    new = os.path.abspath(argv[1] if len(argv) > 1 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    libs = {old: build(old, names), new: build(new, names)}
    same_all = True
    for name in names:
        digests, funcs = {}, {}
        for tree in (old, new):
            sass = bodies(libs[tree][name])
            funcs[tree] = {f: hashlib.sha1(b.encode()).hexdigest()
                           for f, b in sass.items()}
            digests[tree] = sorted(funcs[tree].values())
            print("%s in %s: %d functions, %s SASS lines"
                  % (name, tree, len(sass),
                     sorted(b.count("\n") for b in sass.values())))
            for line in ptxas_lines(tree, name):
                print("  " + line)
        same = digests[old] == digests[new]
        same_all &= same
        print("%s: SASS %s" % (name, "identical" if same else "DIFFERENT"))
        if not same:
            # function by function, where the mangled names match
            for f in sorted(set(funcs[old]) | set(funcs[new])):
                a, b = funcs[old].get(f), funcs[new].get(f)
                state = ("only in " + (old if b is None else new)
                         if a is None or b is None
                         else "identical" if a == b else "DIFFERENT")
                print("  %s: %s" % (f, state))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
