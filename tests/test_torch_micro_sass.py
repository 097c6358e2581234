"""The checks chip_smoke.py makes of the micro kernels (``csrc/micro_ops.cu``
rank_update, joseph, chol, matvec, column_gather and zstats) that need no
card: how it finds a kernel's pass loop in ``cuobjdump -sass`` output and
counts its float32 arithmetic, what each kernel's expression needs, and the
wrappers' refusal of D past the register tile before anything launches."""

import pytest
import torch

import chip_smoke
from live_ekf_slam_tpu_torch.ops import micro_ops as mo

# cuobjdump's layout: a function header, then one instruction a line with its
# address, an optional predicate and the encoding in a comment; branches to
# absolute addresses
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118rank_update_kernelILi2EEEvPKfS2_S2_Pfiiii
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E R4, desc[UR4][R2.64] ;  /* 0x0000000402047981 */
        /*0020*/                   STS [R5], R4 ;                /* 0x0000000405007388 */
        /*0030*/              @P0 BRA 0x10 ;                     /* 0x0000000000000947 */
        /*0040*/                   FMUL R9, R8, R8 ;             /* 0x0000000808097220 */
        /*0050*/                   FFMA R6, -R7, R8, R6 ;        /* 0x0000000807067223 */
        /*0060*/                   FFMA R10, -R7, R9, R10 ;      /* 0x0000000907067223 */
        /*0070*/                   LDS.128 R12, [R3] ;           /* 0x000000000303c984 */
        /*0080*/                   IADD3 R0, R0, 0x1, RZ ;       /* 0x0000000100007810 */
        /*0090*/                   ISETP.GE.AND P0, PT, R0, R11, PT ; /* 0x0000000b0000720c */
        /*00a0*/             @!P0 BRA 0x50 ;                     /* 0x0000000000000947 */
        /*00b0*/                   BRA 0xd0 ;                    /* 0x0000000000000947 */
        /*00c0*/                   FADD R6, R6, R6 ;             /* 0x0000000606067221 */
        /*00d0*/                   EXIT ;                        /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_113joseph_kernelILi2ELi1EEEvPKfS2_S2_S2_S2_S2_Pfiiii
        /*0000*/                   FFMA R6, -R7, R8, R6 ;        /* 0x0000000807067223 */
        /*0010*/                   FADD R6, R6, R9 ;             /* 0x0000000906067221 */
        /*0020*/              @P1 BRA 0x0 ;                      /* 0x0000000000000947 */
        /*0030*/                   EXIT ;                        /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_111chol_kernelILi0EEEvPKfPfiiiii
        /*0000*/                   FADD R6, R6, R9 ;             /* 0x0000000906067221 */
        /*0010*/                   EXIT ;                        /* 0x000000000000794d */
"""


def test_sass_pass_loop_is_the_backward_branch_with_the_most_arithmetic():
    loops = chip_smoke.sass_pass_loops(SASS)
    rank = loops["_ZN12_GLOBAL__N_118rank_update_kernelILi2EEEvPKfS2_S2_Pfiiii"]
    # 0x50 .. 0xa0: not the copy loop at 0x10 .. 0x30, not the FMUL before
    # the loop, not the FADD past the forward branch
    assert rank == {"FFMA": 2, "LDS": 1, "IADD3": 1, "ISETP": 1, "BRA": 1}
    # a loop from the function's first instruction
    jos = loops["_ZN12_GLOBAL__N_113joseph_kernelILi2ELi1EEEvPKfS2_S2_S2_S2_S2_Pfiiii"]
    assert jos == {"FFMA": 1, "FADD": 1, "BRA": 1}
    # no loop, no count
    assert loops["_ZN12_GLOBAL__N_111chol_kernelILi0EEEvPKfPfiiiii"] == {}


def test_sass_names_match_every_register_kernel_instantiation():
    # each entry's mangled template arguments find its kernel, and no two
    # entries find the same one
    stems = {chip_smoke.sass_stem(name) for name in chip_smoke.MICRO_SASS}
    # chol's full and trail variants launch one instantiation; the gathers
    # and zstats at D = 48
    assert len(stems) == len(chip_smoke.MICRO_SASS) == (
        len(mo.RANKS) + 2 + mo.JOSEPH_TERMS + 2 + len(mo.MATVEC_ORDERS)
        + len(mo.GATHER_SPELLINGS) + 1)
    assert "rank_update_kernelILi16EE" in stems and "joseph_kernelILi2ELi7EE" in stems
    assert "chol_kernelILb0EE" in stems and "chol_kernelILb1EE" in stems
    assert "matvec_kernelILi1EE" in stems
    # select is the matvec's row order by a one-hot (kMatvecSelect = 3);
    # take reads two rows a lane at D = 48, zstats three sigma points
    assert chip_smoke.sass_stem("column_gather[select]") == "matvec_kernelILi3EE"
    assert chip_smoke.sass_stem("column_gather[take]") == "column_gather_kernelILi2EE"
    assert chip_smoke.sass_stem("zstats[zstats]") == "zstats_kernelILi3EE"
    assert all(s_.startswith(("rank_update_kernelI", "joseph_kernelI", "chol_kernelI",
                              "matvec_kernelI", "column_gather_kernelI", "zstats_kernelI"))
               for s_ in stems)


@pytest.mark.parametrize("n_terms", range(1, mo.JOSEPH_TERMS + 1))
def test_sass_expression_of_terms_is_their_flops(n_terms):
    # an FFMA is two of the flops chip_smoke's bound counts, FMUL and FADD
    # one each: the first n terms need exactly the instructions their flops
    # say, so that spelling's bound is its issue floor
    want = chip_smoke.MICRO_SASS[f"joseph[terms={n_terms}]"][1]
    flops = 2 * want.get("FFMA", 0) + want.get("FMUL", 0) + want.get("FADD", 0)
    assert flops == chip_smoke.MICRO_TILE_ENTRIES * sum(chip_smoke.JOSEPH_TERM_FLOPS[:n_terms])


def test_sass_expression_of_the_full_spellings():
    # prod9 and hoist: 11 products, 8 sums and a negation by the bound's
    # count; the negation folds into an operand, 6 or 5 products into FFMA
    entries = chip_smoke.MICRO_TILE_ENTRIES
    for sp in ("prod9", "hoist"):
        want = chip_smoke.MICRO_SASS[f"joseph[{sp}]"][1]
        assert (2 * want["FFMA"] + want["FMUL"] + want["FADD"]
                == entries * (chip_smoke.JOSEPH_FLOPS[sp] - 1))
    for r in mo.RANKS:
        assert chip_smoke.MICRO_SASS[f"rank_update[R={r}]"][1] == {"FFMA": entries * r}


@pytest.mark.parametrize("op", ["rank_update", "joseph", "chol", "matvec", "select"])
def test_register_kernels_refuse_d_past_the_tile_before_launching(op, monkeypatch):
    # a CUDA tensor takes the kernel's path; here the path is forced on CPU
    # tensors, which must raise before anything is built or launched
    monkeypatch.setattr(mo, "_on_cpu", lambda t, what: False)
    monkeypatch.setattr(mo, "_launch", lambda *a: pytest.fail("launched"))
    d = mo.TILE + 1
    p, v = torch.zeros(2, d, d), torch.zeros(2, d)
    with pytest.raises(ValueError, match=f"D <= {mo.TILE}.*D = {d}"):
        if op == "rank_update":
            mo.rank_update(p, v[:, None], v[:, None], 1)
        elif op == "joseph":
            mo.joseph(p, v, v, v, v, torch.zeros(2, 3), 1)
        elif op == "chol":
            mo.chol(p, 1, "lower")
        elif op == "select":
            mo.column_gather(p, torch.zeros(2, dtype=torch.int32), 1, "select")
        else:
            mo.matvec(p, v[:, None], 1, "row")


@pytest.mark.parametrize("op", ["take", "zstats"])
def test_take_and_zstats_launch_past_the_tile(op, monkeypatch):
    # they keep their inputs in shared memory and serve any D that fits it:
    # the wrapper launches at D = 49 as at 48
    monkeypatch.setattr(mo, "_on_cpu", lambda t, what: False)
    launched = []
    monkeypatch.setattr(mo, "_launch", lambda family, entry, dev, *a: launched.append(entry))
    d = mo.TILE + 1
    if op == "take":
        mo.column_gather(torch.zeros(2, d, d), torch.zeros(2, dtype=torch.int32), 1, "take")
    else:
        mo.zstats(torch.zeros(2, 3, d), torch.zeros(2, 3, d), torch.zeros(2, 2),
                  torch.zeros(2, d), 1)
    assert launched == ["les_micro_" + ("column_gather" if op == "take" else op)]


def test_sass_pass_loops_keeps_only_the_named_functions():
    loops = chip_smoke.sass_pass_loops(SASS, keep=("joseph_kernel",))
    assert list(loops) == ["_ZN12_GLOBAL__N_113joseph_kernelILi2ELi1EEEvPKfS2_S2_S2_S2_S2_Pfiiii"]
    assert loops[next(iter(loops))] == {"FFMA": 1, "FADD": 1, "BRA": 1}


def test_design_shared_loads_of_a_pass():
    # the 16-byte loads chip_smoke holds each pass loop's LDS count to: none
    # where rank_update keeps k and h in registers, five a term above; five
    # for each of joseph's first four terms and one for s; five for each of
    # the 12 pivots of chol's loop; twelve, a whole vector, for a matvec
    # and the redesigned gathers and zstats: select a matvec's 12, take a
    # 4-byte load for each of its two rows a lane, zstats four 4-byte loads
    # (x, y, yaw, the column's weight) for each of its three sigma points
    loads = {name: chip_smoke.tile_lds(*name[:-1].split("["))
             for name in chip_smoke.MICRO_SASS}
    assert loads == {"rank_update[R=1]": 0, "rank_update[R=2]": 0, "rank_update[R=4]": 0,
                     "rank_update[R=8]": 40, "rank_update[R=16]": 80,
                     "joseph[prod9]": 21, "joseph[hoist]": 21,
                     "joseph[terms=1]": 5, "joseph[terms=2]": 10, "joseph[terms=3]": 15,
                     "joseph[terms=4]": 20, "joseph[terms=5]": 21, "joseph[terms=6]": 21,
                     "joseph[terms=7]": 21, "chol[full]": 60, "chol[lower]": 60,
                     "matvec[row]": 12, "matvec[col]": 12, "matvec[unrolled]": 12,
                     "column_gather[select]": 12, "column_gather[take]": 2,
                     "zstats[zstats]": 12}


@pytest.mark.parametrize("case", [{"op": "rank_update", "rank": 2, "passes": 4096},
                                  {"op": "rank_update", "rank": 16, "passes": 512},
                                  {"op": "joseph", "spelling": "prod9", "passes": 2000},
                                  {"op": "joseph", "spelling": "terms", "n_terms": 3,
                                   "passes": 2000}])
def test_shared_bytes_of_a_register_case_follow_its_design(case):
    # a pass's warp-wide 16-byte loads, one 128-byte wavefront each (a
    # row group's, a column group's or a broadcast word), and once a world P
    # in and out of the staging area (four 4-byte accesses an entry) and the
    # vectors written in their padded layout
    b, d = 4096, 48
    passes, loads = case["passes"], {2: 0, 16: 80}.get(case.get("rank"))
    if case["op"] == "joseph":
        loads = 21 if case["spelling"] == "prod9" else 15
    vectors = {2: 0, 16: 16}.get(case.get("rank"), 4)
    once = 16.0 * d * d + 4.0 * vectors * 112 + 16.0 * (case["op"] == "joseph")
    want = b * (passes * 128.0 * loads + once)
    assert chip_smoke.micro_work({**case, "args": ()}, b, d)[2] == want
    assert chip_smoke.tile_smem_bytes(case, b, d) == want


def _dump(lds_extra: int = 0, hoisted: str = "", extra: tuple = ()) -> str:
    # a canned disassembly of every micro kernel: its pass loop holds
    # exactly its expression and the design's shared loads (plus lds_extra),
    # but the kernel named ``hoisted``, whose loop lacks the first
    # instruction of its expression; ``extra`` = (name, op) adds op to one
    out = ["\tcode for sm_90a"]
    for name, (targs, expression) in chip_smoke.MICRO_SASS.items():
        op, variant = name[:-1].split("[")
        out.append(f"\t\tFunction : _ZN12_GLOBAL__N_1{chip_smoke.sass_stem(name)}Pfiiii")
        ops = [o for o, k in expression.items() for _ in range(k)]
        if name == hoisted:
            ops.remove(ops[0])
        if extra and name == extra[0]:
            ops.append(extra[1])
        if "FFMA" not in ops and "FADD" not in ops:
            ops.append("FFMA")  # zstats' polynomials: float32 arithmetic in its loop
        ops += ["LDS.128"] * (chip_smoke.tile_lds(op, variant) + lds_extra)
        for i, o in enumerate(ops + ["BRA"]):
            rest = " 0x0 ;" if o == "BRA" else " R1, R2 ;"
            out.append(f"        /*{16 * i:04x}*/                   {o}{rest}")
        out.append(f"        /*{16 * len(ops) + 16:04x}*/                   EXIT ;")
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("lds_extra", [0, 1])
def test_micro_sass_holds_each_loop_to_its_designs_shared_loads(lds_extra, monkeypatch,
                                                                tmp_path):
    monkeypatch.setattr(chip_smoke._build, "find_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **k: None)

    def run(cmd, **kw):
        assert cmd == [str(tmp_path / "cuobjdump"), "-sass", str(tmp_path / "lib.so")]
        return type("Done", (), {"stdout": _dump(lds_extra)})()

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    if lds_extra:
        with pytest.raises(AssertionError, match="other shared loads than its design"):
            chip_smoke.micro_sass(tmp_path / "lib.so")
    else:
        rows = chip_smoke.micro_sass(tmp_path / "lib.so")
        assert all(r["matches_expression"] and r["lds"] == r["design_lds"]
                   for r in rows.values())
        assert rows["rank_update[R=16]"]["lds"] == 80


NEW_KERNELS = [name for name in chip_smoke.MICRO_SASS if name.startswith(("chol", "matvec"))]


@pytest.mark.parametrize("hoisted", NEW_KERNELS + list(chip_smoke.MICRO_SASS_EXACT))
def test_micro_sass_raises_on_a_hoisted_chol_or_matvec_loop(hoisted, monkeypatch, tmp_path):
    # the design's loads but one FFMA fewer than the expression in one
    # kernel's loop: part of a pass or a pivot moved out of it
    monkeypatch.setattr(chip_smoke._build, "find_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: type("Done", (), {"stdout": _dump(hoisted=hoisted)})())
    with pytest.raises(AssertionError, match=r"hoisted\).*" + hoisted.replace("[", r"\["),):
        chip_smoke.micro_sass(tmp_path / "lib.so")


@pytest.mark.parametrize("name,op", [("zstats[zstats]", "MUFU.RSQ"),
                                     ("column_gather[take]", "FADD"),
                                     ("column_gather[select]", "FFMA")])
def test_micro_sass_holds_the_redesigned_loops_exactly(name, op, monkeypatch, tmp_path):
    # one instruction more than the design in a redesigned loop raises: a
    # second square root a sigma point (z evaluated again), a second add a
    # row, a product more than the matvec's
    monkeypatch.setattr(chip_smoke._build, "find_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: type("Done", (), {"stdout": _dump(extra=(name, op))})())
    with pytest.raises(AssertionError, match=r"other operations than its design.*"
                       + name.replace("[", r"\[")):
        chip_smoke.micro_sass(tmp_path / "lib.so")


def test_sass_counts_mufu_by_its_function():
    # zstats' entry counts its IEEE square roots: MUFU.RSQ apart from the
    # division's MUFU.RCP
    sass = ("\t\tFunction : _ZN12_GLOBAL__N_113zstats_kernelILi3EEEvPKfS2_S2_S2_Pfiiii\n"
            "        /*0000*/                   MUFU.RSQ R3, R2 ;\n"
            "        /*0010*/                   MUFU.RCP R4, R2 ;\n"
            "        /*0020*/                   FFMA R5, R4, R3, R2 ;\n"
            "        /*0030*/              @P0 BRA 0x0 ;\n")
    loop = chip_smoke.sass_pass_loops(sass)["_ZN12_GLOBAL__N_113zstats_kernelILi3EEEvPKfS2_S2_S2_Pfiiii"]
    assert loop == {"MUFU.RSQ": 1, "MUFU.RCP": 1, "FFMA": 1, "BRA": 1}
    assert chip_smoke.MICRO_SASS["zstats[zstats]"][1] == {"MUFU.RSQ": chip_smoke.ZSTATS_ROUNDS}


@pytest.mark.parametrize("order", mo.MATVEC_ORDERS)
def test_sass_expression_of_matvec_is_two_lines_of_products(order):
    # a lane multiplies its two lines of the padded matrix by the vector,
    # one FFMA a product: the warp's 32 x 96 cover the matrix's D x D
    # products (the second line idles on lanes 16-31); the row order adds
    # its two sums onto out, the column order first sums its two lines over
    # the butterfly's tree of the 32 lanes' partial sums
    want = chip_smoke.MICRO_SASS[f"matvec[{order}]"][1]
    tile = chip_smoke.MICRO_TILE
    assert want["FFMA"] == 2 * tile and 32 * want["FFMA"] >= tile * tile
    assert want.get("FADD", 0) == {"row": 2, "col": 2 * 31 + 2, "unrolled": 0}[order]
    assert "FMUL" not in want


@pytest.mark.parametrize("variant", ["full", "lower"])
def test_sass_expression_of_chol_is_its_pivots_updates(variant):
    # each of the loop's 12 pivots: the warp's 32 x 72 FFMA are the trailing
    # update of the whole padded tile, its 12 FMUL a lane scale the column
    # (every lane executes them), and the pivot's own square root and
    # division come on top
    want = chip_smoke.MICRO_SASS[f"chol[{variant}]"][1]
    block, tile = chip_smoke.CHOL_BLOCK, chip_smoke.MICRO_TILE
    pivot = chip_smoke.CHOL_PIVOT_OPS
    assert 32 * (want["FFMA"] - block * pivot.get("FFMA", 0)) == block * tile * tile
    assert want["FMUL"] - block * pivot.get("FMUL", 0) == block * 12
    assert want.get("FADD", 0) == block * pivot.get("FADD", 0)
    assert want == chip_smoke.MICRO_SASS["chol[full]"][1]  # one code for every variant


@pytest.mark.parametrize("case", [
    {"op": "chol", "variant": "lower", "du": 44, "passes": 100},
    {"op": "chol", "variant": "full", "du": 1, "passes": 3},
    {"op": "matvec", "order": "row", "passes": 4000, "vectors": 4},
    {"op": "matvec", "order": "col", "passes": 2000, "vectors": 1}])
def test_work_of_chol_and_matvec_follows_their_design(case):
    # chol: P staged in and out, the lanes' copies written once and read by
    # every factorisation, each pivot's column stored by four lanes (seven
    # stores) and read by all 32 in five loads (none after the last pivot),
    # a wavefront each; matvec: L staged and read once, the vectors written
    # padded, every matvec read as 12 broadcast wavefronts. The flops
    # executed are the SASS expression's over the warp
    b, d = 4096, 48
    n = case["passes"]
    c = {**case, "args": (None, torch.zeros(1, case.get("vectors", 1), d))}
    flops, nbytes, smem, executed = chip_smoke.micro_work(c, b, d)
    if case["op"] == "chol":
        du = case["du"]
        copies = 32 * 4.0 * 72
        want = b * (16.0 * d * d + copies + n * (copies + du * 7 * 128.0 + (du - 1) * 5 * 128.0))
        assert executed == n * b * (32 * (2.0 * 72 * (du - 1) + 12 * du) + 2.0 * du)
        assert nbytes == 2 * 4.0 * b * d * d
    else:
        a = case["vectors"]
        want = b * (8.0 * d * d + 4.0 * a * d + n * 128.0 * 12)
        expr = chip_smoke.MICRO_SASS[f"matvec[{case['order']}]"][1]
        adds = expr.get("FADD", 0) - 2  # the two sums onto out are not counted
        assert executed == n * b * 32 * (2.0 * expr["FFMA"] + adds)
        assert flops == n * b * 2.0 * d * d
    assert smem == want == chip_smoke.tile_smem_bytes(c, b, d)
    assert executed >= flops


@pytest.mark.parametrize("case", [
    {"op": "column_gather", "spelling": "take", "passes": 60000},
    {"op": "column_gather", "spelling": "select", "passes": 6000},
    {"op": "zstats", "passes": 4000}])
def test_work_of_the_gathers_and_zstats_follows_their_design(case):
    # take: P staged once (4 bytes an entry), each pass two rounds of the
    # lanes' rows (one wavefront each), one add a lane a row; select: the
    # matvec's row order, L staged in and read once, the one-hot padded to 48,
    # 12 broadcasts a pass, 96 FFMA a lane; zstats: 7 floats a column staged,
    # three rounds of four loads a pass, each sigma point once and each
    # column's six terms on both its lanes
    b, d = 4096, 48
    n = case["passes"]
    flops, nbytes, smem, executed = chip_smoke.micro_work(case, b, d)
    if case["op"] == "zstats":
        assert flops == n * b * chip_smoke.ZSTATS_FLOPS * d
        assert smem == b * (4.0 * 7 * d + n * 128.0 * 12)
        assert executed == n * b * d * (chip_smoke.ZSTATS_FLOPS + 18.0)
        assert executed < n * b * d * (chip_smoke.ZSTATS_FLOPS + 80.0)  # not z twice
        return
    assert flops == n * b * d and nbytes == 4.0 * b * (d * d + 1 + d)
    if case["spelling"] == "take":
        assert smem == b * (4.0 * d * d + n * 128.0 * 2)
        assert executed == n * b * 32 * 2.0
    else:
        assert smem == b * (8.0 * d * d + 4.0 * 48 + n * 128.0 * 12)
        assert executed == n * b * 32 * 2.0 * 96


@pytest.mark.parametrize("tool,op", [("micro_downdate", "rank_update"),
                                     ("micro_ukf_probe", "rank_update"),
                                     ("micro_ukf", "joseph"),
                                     ("micro_ukf_probe", "joseph"),
                                     ("micro_ukf", "chol"),
                                     ("micro_ukf", "matvec"),
                                     ("micro_ukf_probe", "matvec"),
                                     ("micro_downdate", "column_gather"),
                                     ("micro_ukf", "zstats")])
def test_occupancy_kwargs_of_a_tool_case_are_the_case_own(tool, op):
    # chip_smoke.py and tools.kernel_ab ask micro_ops.occupancy for a
    # variant by its name; the keywords must be those the case launches with
    import importlib

    mod = importlib.import_module(f"live_ekf_slam_tpu_torch.tools.{tool}")
    cases = [c for c in mod.cases(2, "cpu", passes=1) if c["op"] == op]
    assert cases
    for c in cases:
        vectors = c["args"][1].shape[1] if op == "matvec" else 4
        kw = mo.occupancy_kwargs(op, c["variant"], vectors)
        want = {"rank_update": lambda: {"rank": c["rank"]},
                "joseph": lambda: {"spelling": c["spelling"],
                                   "n_terms": c.get("n_terms", mo.JOSEPH_TERMS)},
                "chol": lambda: {"variant": c["variant"]},
                "matvec": lambda: {"order": c["order"], "vectors": vectors},
                "column_gather": lambda: {"spelling": c["spelling"]},
                "zstats": lambda: {}}[op]()
        assert kw == want, (c["name"], kw)
