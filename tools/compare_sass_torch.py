"""Compare the compiled code of kernels between two trees on a machine with
``nvcc`` and ``cuobjdump`` (the CUDA toolkit under /usr/local/cuda).

    python3 tools/compare_sass_torch.py OLD_TREE [NEW_TREE] [--kernels a,b]

Each tree is a checkout of this repository (NEW_TREE defaults to the one
that holds this script); the kernels default to K1 and K3 (``cmux_step``,
``blind_rotate_chunk``).  Each tree builds its own libraries in a process
of its own (``nufhe_tpu_torch/kernels/build.py``, every kernel of the tree
at once, into the tree's ``_build/``); then, for each kernel, the
``cuobjdump -sass`` body of every function (its header line, which holds
the mangled name, left out) is
compared as a multiset between the trees, and both trees' ``ptxas``
register and spill lines are printed.  Exits 1 if any kernel's code
differs.  A template argument added with a default changes the mangled
names but not the code, which is what this compares.
"""

import hashlib
import json
import os
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
    """{function header: SASS body} of a shared library."""
    sass = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
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
        digests = {}
        for tree in (old, new):
            funcs = bodies(libs[tree][name])
            digests[tree] = sorted(hashlib.sha1(b.encode()).hexdigest()
                                   for b in funcs.values())
            print("%s in %s: %d functions, %s SASS lines"
                  % (name, tree, len(funcs),
                     sorted(b.count("\n") for b in funcs.values())))
            for line in ptxas_lines(tree, name):
                print("  " + line)
        same = digests[old] == digests[new]
        same_all &= same
        print("%s: SASS %s" % (name, "identical" if same else "DIFFERENT"))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
