"""Each test file's summed time in one or more pytest junit files, side by
side, and the schedule that `pytest -n N --dist loadfile` gives those times.

    python tests/junit_times.py a.xml [b.xml ...]
    python -m pytest tests/ -q -m 'not slow' --collect-only -p no:randomly > order.txt
    python tests/junit_times.py a.xml --order order.txt

The first form prints one row a file (the sum of its cases' times in each
junit, in the order given), sorted by the first column, then the port's
files (`test_torch_*`), the others and everything summed.  With `--order`
(the node ids as `--collect-only -q` prints them) it replays the first
junit's times through pytest-xdist's `loadfile` scheduler instead: files in
order of their test count, most first, ties in collection order; each
worker takes one file, then another whenever a test of its own ends with
two or fewer of its tests left; and prints each worker's end and last
files, and the makespan.  Worker start-up and collection are not in it.
A test helper: the package does not use it.
"""

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def case_times(path: str) -> dict:
    """Seconds by (junit class name, test name) in the junit at `path`: the
    class name is the module's dotted path (`tests.test_x`), and its class
    after it where the test is a method."""
    return {(case.get("classname"), case.get("name")): float(case.get("time"))
            for case in ET.parse(path).getroot().iter("testcase")}


def file_sums(path: str) -> collections.Counter:
    """Seconds by test module (`tests.test_x`) in the junit at `path`."""
    sums = collections.Counter()
    for (classname, _), seconds in case_times(path).items():
        sums[".".join(classname.split(".")[:2])] += seconds
    return sums


def _key(node: str):
    """`case_times`' key of a node id `tests/test_x.py[::Class]::name`."""
    path, *parts = node.split("::")
    return (".".join([path[:-3].replace("/", "."), *parts[:-1]]), parts[-1])


def loadfile_schedule(order, times, workers: int):
    """`order`: node ids `tests/test_x.py::name`; `times`: `case_times`.
    Returns [(end seconds, [files in the order taken])] a worker."""
    units = collections.OrderedDict()
    for node in order:
        units.setdefault(node.split("::")[0], []).append(node)
    queue = collections.deque(sorted(units.items(), key=lambda kv: -len(kv[1])))
    pending = [collections.deque() for _ in range(workers)]
    taken = [[] for _ in range(workers)]
    ends = [0.0] * workers

    def take(w):
        path, nodes = queue.popleft()
        pending[w].extend(times.get(_key(n), 0.0) for n in nodes)
        taken[w].append(path)

    for w in range(workers):
        take(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            take(w)
    clock = [(0.0, w) for w in range(workers)]
    while clock:
        t, w = heapq.heappop(clock)
        if not pending[w]:
            ends[w] = t
            continue
        t += pending[w].popleft()
        if queue and len(pending[w]) <= 2:
            take(w)
        heapq.heappush(clock, (t, w))
    return list(zip(ends, taken))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("junit", nargs="+")
    parser.add_argument("--order", help="node ids, one a line, as --collect-only -q prints them")
    parser.add_argument("--workers", type=int, default=6)
    args = parser.parse_args(argv)
    if args.order:
        with open(args.order) as fh:
            order = [line.strip() for line in fh if "::" in line]
        schedule = loadfile_schedule(order, case_times(args.junit[0]), args.workers)
        for w, (end, files) in enumerate(schedule):
            print(f"gw{w} {end:8.1f}", " ".join(files[-4:]))
        print(f"makespan {max(end for end, _ in schedule):.1f}")
        return 0
    runs = [file_sums(p) for p in args.junit]
    files = sorted(set().union(*runs), key=lambda f: -runs[0][f])
    port = [f for f in files if f.split(".")[-1].startswith("test_torch_")]
    for f in files:
        print(" ".join(f"{r[f]:8.1f}" for r in runs), f)
    for name, group in (("port", port), ("others", [f for f in files if f not in port]),
                        ("all", files)):
        print(" ".join(f"{sum(r[f] for f in group):8.1f}" for r in runs), name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
