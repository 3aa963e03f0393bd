"""chip_smoke.py's readers of the build, on the CPU: the ptxas report and
ptxas's wgmma notes it prints and checks in phase 2, and the edges and
probe kinds it drives.  The phases themselves need the card."""
import pytest

import chip_smoke as cs

K1 = ("_ZN49_GLOBAL__N__9f3fe782_16_hamming_count_cu_7a61f5c812count_kernel"
      "EPK10ulonglong2iS2_iiiPi")
PROBE = "_ZN44_GLOBAL__N__315cb702_11_mma_rate_cu_bd56cfbf17wgmma_rate_kernelEiPi"


@pytest.mark.parametrize("code,text,fn", [
    ("C7514", "Potential Performance Loss: wgmma.mma_async instructions are "
     "serialized due to non wgmma instructions reading accumulator registers "
     "of  a wgmma between start and end of the pipeline stage in the", K1),
    ("C7517", "warpgroup.wait is injected in around line 1571 by compiler to "
     "allow use of registers defined by GMMA in", K1),
    ("C7519", "warpgroup.arrive is injected in around line 257 by compiler to "
     "allow use of registers in GMMA in", PROBE),
])
def test_wgmma_notes(code, text, fn):
    """Each note is kept under its kernel's short name; phase 2 fails when
    a note of count_kernel says its products were serialised."""
    line = f"ptxas info    : ({code}) {text} function '{fn}'"
    notes = cs.wgmma_notes("ptxas info    : Used 96 registers\n" + line)
    name = cs.kernel_name(fn)
    assert list(notes) == [name]
    assert notes[name][0].startswith(code)
    assert ("serialized" in notes[name][0]) == (code == "C7514")


def test_ptxas_report_reads_registers_spills_and_shared():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{K1}' for 'sm_90a'",
        f"ptxas info    : Function properties for {K1}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 16 barriers, 1024 bytes smem",
        f"ptxas info    : Function properties for {PROBE}",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 94 registers, used 1 barriers",
    ])
    assert cs.ptxas_report(log) == {"count_kernel": [96, 0, 0, 1024],
                                    "wgmma_rate_kernel": [94, 4, 12, 0]}


def test_k1_is_held_to_wgmma_and_its_edges():
    """K1 must compile to IGMMA; the wgmma probe measures the product K1
    issues; phase 3b's count edges straddle its m64 tiles and 256-query
    blocks and are ragged against its 128-row database tiles."""
    assert cs.TC_KERNELS["count_kernel"] == "IGMMA"
    fn, kind, _, _, m, n, k, _, issuers = cs.PROBE_KERNELS[
        "s8 wgmma m64n128k32"]
    assert (fn, kind, m, n, k, issuers) == ("wgmma_rate_kernel", 2, 64, 128,
                                            32, 2)
    assert {63, 64, 65, 255, 257} <= set(cs.COUNT_EDGE_NQ)
    assert all(nd % 128 for nd in cs.COUNT_EDGE_ND)


def test_k4_is_held_to_wgmma_and_its_edges():
    """K4 must compile to IGMMA (phase 2 also fails it on IMMA or on a
    serialisation note, as K1); phase 3d's count edges straddle its m64
    tiles and 256-query blocks and are ragged against its 64-row tiles of
    pair rows, even and odd, at each k32 step count and each shift of its
    odd B rows (3L % 4)."""
    assert cs.TC_KERNELS["packed_count_kernel"] == "IGMMA"
    assert {"count_kernel", "packed_count_kernel"} <= set(cs.WGMMA_KERNELS)
    assert {63, 64, 65, 255, 256, 257} <= set(cs.PACKED_EDGE_NQ)
    assert {nd % 2 for nd in cs.PACKED_EDGE_ND} == {0, 1}
    assert all(-(-nd // 2) % 64 for nd in cs.PACKED_EDGE_ND)
    lengths = cs.PACKED_EDGE_LENGTHS
    assert {-(-(3 * L + 1) // 32) for L in lengths} == {1, 2}
    assert {3 * L % 4 for L in lengths} == {0, 1, 2, 3}


def test_k2_is_held_to_wgmma_at_every_kcap():
    """Every kcap the 2-bit top-k is built for (1..128) must compile to
    IGMMA, with no IMMA and no serialisation note (WGMMA_KERNELS); kcap
    1-8, the main path's, must not spill; phase 3b's top-k edges reach
    every list edge and phase 6 prints the mma.sync design's time beside
    each kcap of its sweep."""
    topk = {f"topk_kernel<{k}>" for k in (1, 2, 4, 8, 16, 32, 64, 128)}
    assert topk <= set(cs.WGMMA_KERNELS)
    assert all(cs.TC_KERNELS[fn] == "IGMMA" for fn in topk)
    assert {f"topk_kernel<{k}>" for k in (1, 2, 4, 8)} <= set(
        cs.NO_SPILL_KERNELS)
    assert {1 << (k - 1).bit_length() for k in cs.EDGE_KS} == {
        1, 2, 4, 8, 32, 128}
    assert set(cs.MMA_SYNC_KCAP_MS) == set(cs.SWEEP_KCAPS)


def test_k5_is_held_to_wgmma_at_every_kcap():
    """Every kcap the packed top-k is built for (1..128) must compile to
    IGMMA, with no IMMA and no serialisation note (WGMMA_KERNELS), as its
    own entry beside the 2-bit top-k's; kcap 1-8, the main path's, must
    not spill; phase 3d holds it at the m64 tile and 256-query block edges
    and at every list edge, and phase 7 prints the mma.sync design's time
    beside each kcap of its sweep."""
    kcaps = (1, 2, 4, 8, 16, 32, 64, 128)
    packed = {f"packed_topk_kernel<{k}>" for k in kcaps}
    assert packed <= set(cs.WGMMA_KERNELS)
    assert all(cs.TC_KERNELS[fn] == "IGMMA" for fn in packed)
    assert not any(v == "IMMA" for v in cs.TC_KERNELS.values())
    assert all(cs.WGMMA_KERNELS[fn] != cs.WGMMA_KERNELS[fn[len("packed_"):]]
               for fn in packed)
    assert {f"packed_topk_kernel<{k}>" for k in (1, 2, 4, 8)} <= set(
        cs.NO_SPILL_KERNELS)
    assert {63, 64, 65, 255, 256, 257} <= set(cs.PACKED_EDGE_NQ)
    assert {1 << (k - 1).bit_length() for k in cs.EDGE_KS} == {
        1, 2, 4, 8, 32, 128}
    assert set(cs.PACKED_MMA_SYNC_KCAP_MS) == set(cs.SWEEP_KCAPS)


def test_k1p_is_held_to_wgmma_at_every_step_count():
    """K1', the 3-gram count, must compile to BGMMA (the 1-bit wgmma) at
    every k256 step count it is built for (1..8), with no mma.sync (IMMA,
    BMMA) and no serialisation note (WGMMA_KERNELS), and spill at none; the
    rate probe times the b1 wgmma m64n128k256 it issues, shaped like the s8
    chain; phase 3c holds it at step counts with A in registers (1, 5) and
    in shared memory (7, 8), at odd G (8-byte copies) and even G (16-byte
    copies), and at the m64 tile and 256-query block edges; phase 10 reads
    its time against its product at the probe's rate, 256 bits a step of
    its padded rows."""
    feature = {f"feature_count_kernel<{s}>" for s in range(1, 9)}
    assert feature <= set(cs.WGMMA_KERNELS)
    assert all(cs.TC_KERNELS[fn] == "BGMMA" for fn in feature)
    assert not {"BMMA", "IMMA"} & set(cs.TC_KERNELS.values())
    assert feature <= set(cs.NO_SPILL_KERNELS)
    assert "BGMMA" in cs.SASS_OPS
    fn, kind, _, _, m, n, k, _, issuers = cs.PROBE_KERNELS[
        "b1 wgmma m64n128k256"]
    assert (fn, kind, m, n, k, issuers) == ("wgmma_b1_rate_kernel", 3, 64,
                                            128, 256, 2)
    steps = {-(-g // 4) for g in cs.FEATURE_EDGE_WORDS}
    assert {1, 5, 7, 8} <= steps
    assert {g % 2 for g in cs.FEATURE_EDGE_WORDS} == {0, 1}
    assert {63, 64, 65, 255, 257} <= set(cs.COUNT_EDGE_NQ)
    assert cs.feature_product_ms(1000, 1000, 18, 2.56e9) == pytest.approx(
        1000.0)


def test_count_probe_needs_a_card(capsys):
    """tools/count_probe.py, which times K4 against K1, both top-k
    kernels and K1' on the card, exits 1 and prints no result without
    one."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "count_probe.py")
    spec = importlib.util.spec_from_file_location("count_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert probe.main(os.path.dirname(os.path.dirname(path))) == 1
    assert capsys.readouterr().out == ""


def test_feature_variants_apply_and_need_a_card(capsys):
    """tools/feature_variants.py's edits of K1' each apply once to
    csrc/feature_count.cu as it stands (a variant that no longer applies
    would time the wrong kernel), and without a card it exits 1 and prints
    no result."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "feature_variants", os.path.join(root, "tools", "feature_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(root, "guidemaker_tpu_torch", "csrc",
                           "feature_count.cu")) as fh:
        src = fh.read()
    edited = {name: tool.variant_source(src, edits)
              for name, (edits, _) in tool.VARIANTS.items()}
    assert edited["shipped"] == src
    assert all(edited[name] != src for name in edited if name != "shipped")
    assert tool.main() == 1
    assert capsys.readouterr().out == ""
