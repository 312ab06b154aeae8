"""Encryption at rest of the port (yugabyte_db_tpu_torch/utils/
encryption.py, the SST writer's whole-image encryption and the reader's
decryption) against the reference on the CPU: the same keystream bytes
for the same key and nonce under both ciphers, each package's encrypted
files opening in the other in both envelopes, the same plaintext SST
bytes under the envelope, key rotation and mixed-cipher files side by
side, and an encrypted tablet answering like a plain one.  The
reference's cases of tests/test_observability.py (TestEncryption,
TestAesCtr) run on the port too.  Tolerance: none."""
import os
import secrets

import numpy as np
import pytest

from yugabyte_db_tpu.storage import sst as jsst
from yugabyte_db_tpu.utils import encryption as jenc
from yugabyte_db_tpu_torch.storage import sst as psst
from yugabyte_db_tpu_torch.utils import encryption as penc
from tests.torch_parity import flags_set

requires_aes = pytest.mark.skipif(
    not penc.aes_available(),
    reason="the `cryptography` package is not installed (AES-CTR)")
CIPHERS = [penc.CIPHER_BLAKE2B,
           pytest.param(penc.CIPHER_AES_CTR, marks=requires_aes)]
STREAMS = {penc.CIPHER_BLAKE2B: (jenc.CipherStream, penc.CipherStream),
           penc.CIPHER_AES_CTR: (jenc.AesCtrStream, penc.AesCtrStream)}


@pytest.fixture()
def managers():
    """Both packages' process-wide key managers holding the same fresh
    universe key; restored afterwards."""
    saved = [(m, dict(m.keys), m.active, m.force_cipher)
             for m in (jenc.KEY_MANAGER, penc.KEY_MANAGER)]
    key = secrets.token_bytes(32)
    for m in (jenc.KEY_MANAGER, penc.KEY_MANAGER):
        m.add_key("u1", key)
    yield jenc.KEY_MANAGER, penc.KEY_MANAGER
    for m, keys, active, force in saved:
        m.keys, m.active, m.force_cipher = keys, active, force


def encrypting(on=True):
    return flags_set({"encrypt_data_at_rest": on},
                     {"encrypt_data_at_rest": on})


def test_constants_match_reference():
    assert (penc.MAGIC, penc.MAGIC_V2, penc.CIPHER_BLAKE2B,
            penc.CIPHER_AES_CTR) == (jenc.MAGIC, jenc.MAGIC_V2,
                                     jenc.CIPHER_BLAKE2B,
                                     jenc.CIPHER_AES_CTR)


@pytest.mark.parametrize("cipher", CIPHERS)
def test_keystream_matches_reference(cipher):
    """The keystream (XOR of zeros) and an XOR of random data at random
    offsets and lengths, block aligned or not, equal the reference's."""
    rng = np.random.default_rng(cipher)
    jcls, pcls = STREAMS[cipher]
    for _ in range(12):
        key = rng.bytes(32)
        nonce = rng.bytes(16)
        off = int(rng.integers(0, 5000))
        n = int(rng.integers(0, 700))
        data = rng.bytes(n)
        assert pcls(key, nonce).xor(bytes(n), off) == \
            jcls(key, nonce).xor(bytes(n), off)
        assert pcls(key, nonce).xor(data, off) == \
            jcls(key, nonce).xor(data, off)
    # the counter wraps at 2**128 alike
    if cipher == penc.CIPHER_AES_CTR:
        top = b"\xff" * 16
        assert pcls(b"k" * 32, top).xor(bytes(100), 5) == \
            jcls(b"k" * 32, top).xor(bytes(100), 5)


@pytest.mark.parametrize("cipher", CIPHERS)
def test_envelopes_cross_decrypt(managers, cipher):
    """v2 envelopes written by either package under either cipher open
    in the other; legacy v1 (BLAKE2b) envelopes too."""
    jm, pm = managers
    raw = os.urandom(5000)
    for writer, reader in ((jm, pm), (pm, jm)):
        writer.force_cipher = cipher
        enc = writer.encrypt_file_bytes(raw)
        assert enc.startswith(penc.MAGIC_V2)
        assert enc[len(penc.MAGIC_V2)] == cipher
        assert reader.decrypt_file_bytes(enc) == raw
        assert writer.decrypt_file_bytes(enc) == raw
    nonce = os.urandom(16)
    legacy = (penc.MAGIC + bytes([2]) + b"u1" + nonce
              + penc.CipherStream(pm.keys["u1"], nonce).xor(raw))
    assert pm.decrypt_file_bytes(legacy) == jm.decrypt_file_bytes(legacy) \
        == raw
    assert pm.decrypt_file_bytes(raw) == raw      # not encrypted


@pytest.mark.parametrize("cipher", CIPHERS)
@pytest.mark.parametrize("columnar", [False, True])
def test_encrypted_ssts_open_across_packages(tmp_path, managers, cipher,
                                             columnar):
    """Each package's encrypted SST (row blocks, or columnar-only blocks
    through stream mode, which encryption turns off) opens in the other;
    under the envelope both hold the plain file's bytes."""
    from tests.test_torch_sst import _blocks
    jb, pb, jc, pc = _blocks("lineitem")
    entries = sorted(pc.row_decoder(pb[0]))
    for m in managers:
        m.force_cipher = cipher

    def write(mod, path, blocks, codec):
        w = mod.SstWriter(path, block_rows=500, stream_columnar=columnar,
                          columnar_builder=codec.columnar_builder,
                          key_builder=codec.derive_keys)
        if columnar:
            for b in blocks[:2]:
                w.add_columnar_block(b)
        else:
            for k, v in entries:
                w.add(k, v)
        w.finish()
        return open(path, "rb").read()

    plain = {}
    for name, mod, blocks, codec in (("j", jsst, jb, jc),
                                     ("p", psst, pb, pc)):
        plain[name] = write(mod, str(tmp_path / f"{name}.plain"), blocks,
                            codec)
    assert plain["j"] == plain["p"]
    with encrypting():
        enc = {name: write(mod, str(tmp_path / f"{name}.sst"), blocks,
                           codec)
               for name, mod, blocks, codec in (("j", jsst, jb, jc),
                                                ("p", psst, pb, pc))}
    for name, raw in enc.items():
        assert raw.startswith(penc.MAGIC_V2) and raw[8] == cipher
        assert raw != plain["p"]
        assert managers[1].decrypt_file_bytes(raw) == plain["p"]
        assert managers[0].decrypt_file_bytes(raw) == plain["p"]
    for name in "jp":
        path = str(tmp_path / f"{name}.sst")
        pr = psst.SstReader(path, row_decoder=pc.row_decoder,
                            key_builder=pc.derive_keys)
        jr = jsst.SstReader(path, row_decoder=jc.row_decoder,
                            key_builder=jc.derive_keys)
        assert pr.file_size == jr.file_size == len(plain["p"])
        assert list(pr.iterate()) == list(jr.iterate())
        if columnar:
            cb = pr.columnar_block(1)
            assert np.array_equal(cb.keys, pb[1].keys)


def test_key_rotation_and_mixed_ciphers_in_one_tablet(tmp_path, managers):
    """A tablet whose SSTs were written under two keys and two ciphers
    (and one plain) reads like the reference's, each package opening the
    other's directory."""
    from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
    from yugabyte_db_tpu.tablet import Tablet as JTablet
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.tablet import Tablet
    from tests.torch_parity import (kv_infos, kv_row, kv_tablet_pair,
                                    store_files, write_both)
    jt, pt, jphys, pphys = kv_tablet_pair(str(tmp_path))
    rng = np.random.default_rng(3)
    steps = [("u1", penc.CIPHER_BLAKE2B), ("u2", penc.CIPHER_AES_CTR),
             (None, None), ("u1", penc.CIPHER_AES_CTR)]
    for step, (ver, cipher) in enumerate(steps):
        if cipher == penc.CIPHER_AES_CTR and not penc.aes_available():
            cipher = penc.CIPHER_BLAKE2B
        for m in managers:
            if ver == "u2" and "u2" not in m.keys:
                m.add_key("u2", b"R" * 32)
            m.active = ver or m.active
            m.force_cipher = cipher
        for _ in range(40):
            jphys.advance_micros(5), pphys.advance_micros(5)
            write_both(jt, pt, [("upsert", kv_row(rng, int(rng.integers(
                0, 150))))])
        with encrypting(ver is not None):
            jt.flush(), pt.flush()
    heads = sorted(open(r.path, "rb").read()[:10] for r in pt.regular.ssts)
    assert sum(h.startswith(penc.MAGIC_V2) for h in heads) == 3
    # the SST bytes differ (random nonces) but decrypt to the same files
    files = {n: managers[1].decrypt_file_bytes(b)
             for n, b in store_files(pt.regular).items()}
    assert files == {n: managers[0].decrypt_file_bytes(b)
                     for n, b in store_files(jt.regular).items()}
    read_ht = (pphys.now_micros() << 12) + 1
    want = jt.read(JReq("t1", read_ht=read_ht)).rows
    assert pt.read(ReadRequest("t1", read_ht=read_ht)).rows == want
    jinfo, pinfo = kv_infos("hash")
    pt2 = Tablet("w", pinfo, os.path.join(str(tmp_path), "j"),
                 device="cpu")
    jt2 = JTablet("w", jinfo, os.path.join(str(tmp_path), "p"))
    assert pt2.read(ReadRequest("t1", read_ht=read_ht)).rows == want
    assert jt2.read(JReq("t1", read_ht=read_ht)).rows == want


def test_encrypted_doc_tablet_answers_like_the_plain_one(tmp_path,
                                                         managers):
    """An encrypted tablet of documents (shredded, in whole-image
    encrypted SSTs) gives the plain tablet's answer and the reference's,
    on the port's device path (the CPU here)."""
    from yugabyte_db_tpu.docdb.operations import ReadRequest as JReq
    from yugabyte_db_tpu.models import docbench as jdocs
    from yugabyte_db_tpu.tablet import Tablet as JTablet
    from yugabyte_db_tpu_torch.docdb.operations import ReadRequest
    from yugabyte_db_tpu_torch.docstore import LAST_DOC_STATS
    from yugabyte_db_tpu_torch.models import docbench as pdocs
    from yugabyte_db_tpu_torch.tablet import Tablet
    from yugabyte_db_tpu_torch.utils import hybrid_time as pht
    docs = pdocs.generate_docs(5000, 7)
    ht = pht.HybridTime.from_micros(1_000_000)
    low = {"tpu_min_rows_for_pushdown": 64}
    out = {}
    with flags_set(low, low):
        for enc in (False, True):
            with encrypting(enc):
                pt = Tablet("d", pdocs.docs_info(),
                            str(tmp_path / f"p{enc}"), device="cpu")
                pt.bulk_load(docs, ht=ht, block_rows=1024)
                jt = JTablet("d", jdocs.docs_info(),
                             str(tmp_path / f"j{enc}"))
                jt.bulk_load(docs, block_rows=1024)
            heads = {open(r.path, "rb").read(8) for r in pt.regular.ssts}
            assert (heads == {penc.MAGIC_V2}) == enc
            w, aggs = pdocs.doc_qty_query()
            r = pt.read(ReadRequest("docs", where=w, aggregates=aggs))
            assert r.backend == "tpu" and LAST_DOC_STATS["coverage"] > 0
            jw, jaggs = jdocs.doc_qty_query()
            jr = jt.read(JReq("docs", where=jw, aggregates=jaggs))
            out[enc] = [np.asarray(v).tolist() for v in r.agg_values]
            assert out[enc] == [np.asarray(v).tolist()
                                for v in jr.agg_values]
            # a cold open decrypts the whole image
            cold = Tablet("d", pdocs.docs_info(), str(tmp_path / f"p{enc}"),
                          device="cpu")
            r2 = cold.read(ReadRequest("docs", where=w, aggregates=aggs))
            assert [np.asarray(v).tolist() for v in r2.agg_values] == \
                out[enc]
    assert out[True] == out[False]


@requires_aes
def test_aes_file_without_provider_raises(tmp_path, managers, monkeypatch):
    """An AES-CTR file where no provider imports raises the reference's
    ValueError, in the key manager and in the SST reader."""
    for m in managers:
        m.force_cipher = penc.CIPHER_AES_CTR
    path = str(tmp_path / "a.sst")
    with encrypting():
        w = psst.SstWriter(path)
        for i in range(20):
            w.add(b"k%04d" % i, b"v")
        w.finish()
    raw = open(path, "rb").read()
    monkeypatch.setattr(penc, "aes_available", lambda: False)
    with pytest.raises(ValueError, match="no crypto provider"):
        managers[1].decrypt_file_bytes(raw)
    with pytest.raises(ValueError, match="no crypto provider"):
        psst.SstReader(path)
    # and the manager then writes BLAKE2b files, which still open
    managers[1].force_cipher = None
    assert managers[1].encrypt_file_bytes(b"x")[8] == penc.CIPHER_BLAKE2B


def test_unknown_key_version_raises(managers):
    jm, pm = managers
    enc = pm.encrypt_file_bytes(b"payload")
    del pm.keys["u1"]
    with pytest.raises(ValueError, match="universe key u1 not available"):
        pm.decrypt_file_bytes(enc)
    assert jm.decrypt_file_bytes(enc) == b"payload"


# --- the reference's cases (tests/test_observability.py) on the port -------
class TestEncryption:
    def test_cipher_roundtrip_random_access(self):
        cs = penc.CipherStream(b"k" * 32, b"n" * 16)
        data = bytes(range(256)) * 10
        enc = cs.xor(data)
        assert enc != data
        assert cs.xor(enc) == data
        assert cs.xor(enc[100:200], offset=100) == data[100:200]

    def test_key_manager_envelope(self):
        km = penc.UniverseKeyManager()
        km.generate_key("v1")
        raw = b"hello sst bytes" * 100
        enc = km.encrypt_file_bytes(raw)
        assert enc != raw and km.decrypt_file_bytes(enc) == raw
        km.generate_key("v2")
        assert km.decrypt_file_bytes(enc) == raw

    def test_encrypted_sst_roundtrip(self, tmp_path, managers):
        penc.KEY_MANAGER.generate_key()
        with encrypting():
            p = str(tmp_path / "enc.sst")
            w = psst.SstWriter(p)
            for i in range(50):
                w.add(b"k%04d" % i, b"v%d" % i)
            w.finish()
            raw = open(p, "rb").read()
            assert raw.startswith(b"YBTPUEN")
            assert b"k0001" not in raw
            assert len(list(psst.SstReader(p).iterate())) == 50


class TestAesCtr:
    @requires_aes
    def test_aes_stream_roundtrip_random_access(self):
        cs = penc.AesCtrStream(b"k" * 32, b"n" * 16)
        data = bytes(range(256)) * 10
        enc = cs.xor(data)
        assert enc != data and cs.xor(enc) == data
        for off in (0, 1, 15, 16, 17, 100, 2000):
            assert cs.xor(enc[off:off + 77], offset=off) == \
                data[off:off + 77]

    @requires_aes
    def test_envelope_selects_aes_and_rotates(self):
        km = penc.UniverseKeyManager()
        km.generate_key("v1")
        raw = b"sst bytes " * 200
        enc = km.encrypt_file_bytes(raw)
        assert enc.startswith(penc.MAGIC_V2)
        assert enc[len(penc.MAGIC_V2)] == penc.CIPHER_AES_CTR
        assert km.decrypt_file_bytes(enc) == raw
        km.generate_key("v2")
        enc2 = km.encrypt_file_bytes(raw)
        assert km.decrypt_file_bytes(enc2) == raw
        assert km.decrypt_file_bytes(enc) == raw

    def test_rotation_on_fallback_cipher(self):
        km = penc.UniverseKeyManager()
        km.force_cipher = penc.CIPHER_BLAKE2B
        km.generate_key("b1")
        raw = b"fallback " * 100
        enc = km.encrypt_file_bytes(raw)
        km.generate_key("b2")
        assert km.decrypt_file_bytes(enc) == raw
        assert km.decrypt_file_bytes(km.encrypt_file_bytes(raw)) == raw

    def test_legacy_v1_files_stay_readable(self):
        km = penc.UniverseKeyManager()
        km.add_key("old", b"K" * 32)
        raw = b"legacy payload " * 50
        nonce = secrets.token_bytes(16)
        legacy = (penc.MAGIC + bytes([3]) + b"old" + nonce
                  + penc.CipherStream(b"K" * 32, nonce).xor(raw))
        assert km.decrypt_file_bytes(legacy) == raw

    @requires_aes
    def test_mixed_cipher_files_coexist(self):
        km = penc.UniverseKeyManager()
        km.generate_key("m1")
        raw = b"mixed " * 300
        km.force_cipher = penc.CIPHER_BLAKE2B
        e_b = km.encrypt_file_bytes(raw)
        km.force_cipher = penc.CIPHER_AES_CTR
        e_a = km.encrypt_file_bytes(raw)
        km.force_cipher = None
        assert km.decrypt_file_bytes(e_b) == raw
        assert km.decrypt_file_bytes(e_a) == raw
