"""The port's EasyProtocol envelope and EasyCMS against the reference's
``tests/test_cluster.py`` (the protocol pair and the three CMS tests),
each holding the port's result to the reference package's, and:

* the REST answers the port gave before ``cluster/protocol.py`` grew to
  the reference's whole file (``ack`` alone) are byte-identical after it,
  and equal to the reference's ``ack``;
* the reference's ``SimDevice`` and ``CmsClient`` against the port's
  ``CmsServer``, and the port's against the reference's, give the acks
  each package gives itself (the random ``Token`` and ``TraceId`` set
  aside);
* the platform e2e with a port ``StreamingServer`` as the media server
  (``device="cpu"``, ``cloud_enabled`` presence over the CMS's Redis);
* the ``cms_host`` and ``cms_port`` keys read from TOML and from the
  XML's ``EasyCMSModule`` as the reference reads them.

Every socket wait has a timeout of its own.
"""

import asyncio
import json
import time

import pytest

from easydarwin_tpu.cluster import cms as ref_cms
from easydarwin_tpu.cluster import device as ref_device
from easydarwin_tpu.cluster import protocol as ref_ep
from easydarwin_tpu.cluster import redis_client as ref_redis
from easydarwin_tpu.server import config as ref_config
from easydarwin_tpu_torch import obs
from easydarwin_tpu_torch.cluster import cms, device
from easydarwin_tpu_torch.cluster import protocol as ep
from easydarwin_tpu_torch.cluster import redis_client as port_redis
from easydarwin_tpu_torch.protocol import rtp
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server import config
from easydarwin_tpu_torch.utils.client import RtspClient

#: seconds any one socket call may take (over the CMS's own 5 s wait for
#: a device's push ack)
SOCKET_S = 10.0

#: (name, protocol, cms, device, redis) of each package
REF = ("ref", ref_ep, ref_cms, ref_device, ref_redis)
PORT = ("port", ep, cms, device, port_redis)


def _t(coro):
    """``coro`` under its own timeout."""
    return asyncio.wait_for(coro, SOCKET_S)


@pytest.fixture(autouse=True)
def _fresh_ledger():
    yield
    obs.LEDGER.reset()


# ------------------------------------------------------------- protocol
def test_protocol_roundtrip():
    texts = []
    for _n, proto, *_ in (REF, PORT):
        m = proto.Message(proto.MSG_CS_GET_STREAM_REQ, cseq=7,
                          body={"Serial": "cam1", "Channel": "0"})
        text = m.to_json()
        p = proto.Message.parse(text)
        assert p.message_type == proto.MSG_CS_GET_STREAM_REQ
        assert p.cseq == 7 and p.error is None and p.trace_id is None
        assert p.body["Serial"] == "cam1"
        a = proto.Message.parse(proto.ack(proto.MSG_SC_GET_STREAM_ACK, 7,
                                          proto.ERR_OK, {"URL": "rtsp://x"}))
        assert a.error == 200 and a.body["URL"] == "rtsp://x"
        t = proto.Message(proto.MSG_CS_PTZ_CTRL_REQ, 3, error=404,
                          body={"Serial": "c"}, trace_id="ab12").to_json()
        assert proto.Message.parse(t).trace_id == "ab12"
        texts.append((text, t))
    assert texts[0] == texts[1]
    # the header order: CSeq, MessageType, Version, TraceId, ErrorNum,
    # ErrorString
    head = json.loads(texts[1][1])["EasyDarwin"]["Header"]
    assert list(head) == ["CSeq", "MessageType", "Version", "TraceId",
                          "ErrorNum", "ErrorString"]
    # every message code equals the reference's
    codes = {k: getattr(ref_ep, k) for k in dir(ref_ep)
             if k.startswith(("MSG_", "ERR_"))}
    assert codes == {k: getattr(ep, k) for k in dir(ep)
                     if k.startswith(("MSG_", "ERR_"))}


@pytest.mark.parametrize("text", [
    "not json", "{}", '{"EasyDarwin": {"Header": {"MessageType": "zz"}}}',
    '{"EasyDarwin": 3}', '{"EasyDarwin": {"Body": {}}}'])
def test_protocol_parse_errors(text):
    for _n, proto, *_ in (REF, PORT):
        with pytest.raises(proto.ProtocolError):
            proto.Message.parse(text)


def _ack_before(message_type: int, cseq: int = 1, error: int = 200,
                body: dict | None = None) -> str:
    """The port's ``ack`` as it was before ``protocol.py`` took the
    reference's ``Message`` (its body, verbatim)."""
    strings = {200: "Success OK", 401: "Unauthorized", 404: "Not Found",
               400: "Bad Request", 600: "Device Offline",
               500: "Internal Error"}
    header = {"CSeq": str(cseq), "MessageType": f"0x{message_type:04X}",
              "Version": "1.0", "ErrorNum": str(error),
              "ErrorString": strings.get(error, "Unknown")}
    return json.dumps({"EasyDarwin": {"Header": header,
                                      "Body": body or {}}}, indent=1)


@pytest.mark.parametrize("mt", [ep.MSG_SC_EXCEPTION, ep.MSG_SC_GET_STREAM_ACK,
                                ep.MSG_SC_SERVER_INFO_ACK,
                                ep.MSG_SC_RTSP_LIVE_SESSIONS_ACK,
                                ep.MSG_SC_BASE_CONFIG_ACK])
def test_rest_answers_are_byte_identical_after_the_extension(mt):
    bodies = [None, {}, {"Token": "ab" * 16},
              {"Detail": "shard refused (crc/gen)"},
              {"Sessions": [{"Path": "/a", "N": 1}], "Count": "1"}]
    for err in (200, 400, 401, 404, 500, 600, 777):
        for cseq in (1, 9):
            for body in bodies:
                want = _ack_before(mt, cseq, err, body)
                assert ep.ack(mt, cseq, err, body) == want
                assert ref_ep.ack(mt, cseq, err, body) == want
    assert ep.ack(mt) == _ack_before(mt)


async def test_rest_server_answers_are_the_envelope_of_before(tmp_path):
    """A running server's envelope answers (an unknown command's and a
    DVR-less ``dvrwindow``'s 404, ``getserverinfo``, a 401) equal the
    pre-extension ``ack`` byte for byte."""
    cfg = ServerConfig(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                       log_folder=str(tmp_path), movie_folder=str(tmp_path),
                       access_log_enabled=False)
    app = StreamingServer(cfg, device="cpu")
    await app.start()
    try:
        rest = app.rest
        assert (await rest.route("GET", "/api/v1/nosuch", {}, b""))[1] \
            == _ack_before(ep.MSG_SC_EXCEPTION, error=404)
        assert (await rest.route("GET", "/api/v1/dvrwindow?path=/a&track=x"
                                 "&win=0", {}, b""))[:2] == (
            404, _ack_before(ep.MSG_SC_EXCEPTION, error=404))
        got = await rest.route("GET", "/api/v1/getserverinfo", {}, b"")
        doc = json.loads(got[1])
        assert got[1] == _ack_before(ep.MSG_SC_SERVER_INFO_ACK,
                                     body=doc["EasyDarwin"]["Body"])
        cfg.auth_enabled = True
        got = await rest.route("GET", "/api/v1/getserverinfo", {}, b"")
        assert got == (401, _ack_before(ep.MSG_SC_EXCEPTION, error=401))
    finally:
        await app.stop()


# ------------------------------------------------------------------ CMS
async def test_cms_reaps_lapsed_devices(tmp_path):
    """A device whose keepalive lapsed is reaped with one
    ``cms.device_offline`` event, lapse alone deciding, as the
    reference's."""
    got = {}
    for name, _p, cms_mod, _d, red in (REF, PORT):
        srv = cms_mod.CmsServer(red.InMemoryRedis(), bind_ip="127.0.0.1",
                                snap_dir=str(tmp_path / name),
                                device_timeout_sec=10.0)
        await srv.start()
        try:
            class _SilentSocket:
                """An open-looking writer whose network died without a
                FIN."""
                closed = False

                def is_closing(self):
                    return False

                def close(self):
                    self.closed = True

            now = time.time()
            srv.devices["dead1"] = cms_mod.DeviceRecord(
                "dead1", name="cam-dead", last_seen=now - 60)
            w = _SilentSocket()
            srv.devices["ghost"] = cms_mod.DeviceRecord(
                "ghost", writer=w, last_seen=now - 60)
            srv.devices["fresh"] = cms_mod.DeviceRecord("fresh",
                                                        last_seen=now)
            reaped = srv.reap()
            got[name] = (sorted(reaped), w.closed, sorted(srv.devices),
                         srv.reap())
        finally:
            await srv.stop()
    assert got["port"] == got["ref"]
    assert got["port"] == (["dead1", "ghost"], True, ["fresh"], [])
    evs = [r for r in obs.EVENTS.tail(50)
           if r.get("event") == "cms.device_offline"]
    assert {e["serial"] for e in evs} >= {"dead1", "ghost"}


async def test_cms_offline_device_and_unknown(tmp_path):
    got = {}
    for name, proto, cms_mod, dev_mod, red in (REF, PORT):
        srv = cms_mod.CmsServer(red.InMemoryRedis(), bind_ip="127.0.0.1",
                                snap_dir=str(tmp_path / name))
        await srv.start()
        try:
            client = dev_mod.CmsClient("127.0.0.1", srv.port)
            ack = await _t(client.get_stream("ghost"))
            ptz = await _t(client.ptz("ghost", "up"))
            info = await _t(client.request(proto.MSG_CS_DEVICE_INFO_REQ,
                                        {"Serial": "ghost"}))
            got[name] = [(m.message_type, m.error, m.body)
                         for m in (ack, ptz, info)]
        finally:
            await srv.stop()
    assert got["port"] == got["ref"]
    assert [e for _t, e, _b in got["port"]] == [
        ep.ERR_DEVICE_OFFLINE, ep.ERR_DEVICE_OFFLINE, ep.ERR_NOT_FOUND]


def _norm(msg) -> tuple:
    """An ack without what is random by design (the register ``Token``,
    a minted ``TraceId``, the snapshot file's time stamp)."""
    body = dict(msg.body)
    if "Token" in body:
        body["Token"] = len(body["Token"])
    if "SnapURL" in body:
        body["SnapURL"] = body["SnapURL"].rsplit("_", 1)[0]
    return (msg.message_type, msg.cseq, msg.error, body)


async def _device_flow(srv_side, dev_side, tmp_path) -> list:
    """One device and one client of ``dev_side`` against a CMS of
    ``srv_side``: the acks of register, list, info, get stream (twice),
    PTZ, preset, talkback, free stream, an unknown request and a
    snapshot, and what the device saw."""
    name, _p, cms_mod, _d, red = srv_side
    _n, proto, _c, dev_mod, _r = dev_side
    redis = red.InMemoryRedis()
    await redis.hset("EasyDarwin:media-1", {
        "IP": "10.0.0.7", "RTSP": "554", "HTTP": "10008", "Load": "0"})
    srv = cms_mod.CmsServer(redis, bind_ip="127.0.0.1",
                            snap_dir=str(tmp_path / f"snaps-{name}"))
    await srv.start()
    pushes, stops = [], []

    async def on_push(body):
        pushes.append(dict(body))
        return True

    async def on_stop(body):
        stops.append(dict(body))

    dev = dev_mod.SimDevice("cam0042", name="lobby", on_push=on_push,
                            on_stop=on_stop)
    out = []
    try:
        await _t(dev.connect("127.0.0.1", srv.port))
        out.append(("token", len(dev.token or "")))
        client = dev_mod.CmsClient("127.0.0.1", srv.port)
        out.append(("list", await _t(client.device_list())))
        out.append(_norm(await _t(client.request(
            proto.MSG_CS_DEVICE_INFO_REQ, {"Serial": "cam0042"}, cseq=2))))
        out.append(_norm(await _t(client.get_stream("cam0042"))))
        out.append(_norm(await _t(client.get_stream("cam0042"))))
        out.append(_norm(await _t(client.ptz("cam0042", "left"))))
        out.append(_norm(await _t(client.request(
            proto.MSG_CS_PRESET_CTRL_REQ, {"Serial": "cam0042",
                                           "Preset": "3"}, cseq=4))))
        out.append(_norm(await _t(client.request(
            proto.MSG_CS_TALKBACK_CTRL_REQ, {"Serial": "cam0042"}, cseq=5))))
        out.append(_norm(await _t(client.request(
            proto.MSG_CS_FREE_STREAM_REQ, {"Serial": "cam0042",
                                           "Channel": "0"}, cseq=6))))
        out.append(_norm(await _t(client.request(0x0777, {}, cseq=8))))
        t0 = time.monotonic()
        while (len(dev.ctrl_log) < 3 or not stops) \
                and time.monotonic() - t0 < 5.0:
            await asyncio.sleep(0.01)
        snap = await _t(dev.post_snapshot("127.0.0.1", srv.port,
                                          b"\xff\xd8x"))
        with open(snap[len("file://"):], "rb") as fh:
            out.append(("snap", fh.read(), snap.rsplit("/", 1)[1]
                        .rsplit("_", 1)[0]))
        out.append(("pushes", pushes, "stops", stops,
                    "ctrl", dev.ctrl_log))
    finally:
        await dev.close()
        await srv.stop()
    return out


@pytest.mark.parametrize("pair", ["ref-device-port-cms",
                                  "port-device-ref-cms"])
async def test_devices_and_clients_of_either_package_get_equal_acks(
        tmp_path, pair):
    dev_side, srv_side = (REF, PORT) if pair.startswith("ref") \
        else (PORT, REF)
    mixed = await _device_flow(srv_side, dev_side, tmp_path / "mixed")
    own = await _device_flow(srv_side, srv_side, tmp_path / "own")
    other = await _device_flow(dev_side, dev_side, tmp_path / "other")
    assert mixed == own == other
    acks = {m[0]: m for m in mixed if isinstance(m[0], int)}
    assert acks[ep.MSG_SC_GET_STREAM_ACK][3]["URL"] \
        == "rtsp://10.0.0.7:554/cam0042/0.sdp"
    assert acks[ep.MSG_SC_EXCEPTION][2] == ep.ERR_BAD_REQUEST
    pushes = mixed[-1][1]
    assert len(pushes) == 1 and pushes[0]["Port"] == "554"


async def test_cms_platform_e2e_device_to_player(tmp_path):
    """The reference's flow with a port media server: the device
    registers, a client asks the CMS for its stream, the CMS picks the
    least-loaded media server from the port server's presence records,
    the device pushes there and a player plays the relayed stream."""
    redis = port_redis.InMemoryRedis()
    media = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        wan_ip="127.0.0.1", cloud_enabled=True, server_id="media-1",
        reflect_interval_ms=5, log_folder=str(tmp_path),
        movie_folder=str(tmp_path), access_log_enabled=False),
        device="cpu", redis_client=redis)
    await media.start()
    srv = cms.CmsServer(redis, bind_ip="127.0.0.1",
                        snap_dir=str(tmp_path / "snaps"))
    await srv.start()
    push_sdp = ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=dev\r\n"
                "c=IN IP4 0.0.0.0\r\nt=0 0\r\na=control:*\r\n"
                "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
                "a=control:trackID=1\r\n")
    pusher = RtspClient()
    player = RtspClient()

    def vid(seq, nal=5):
        return rtp.RtpPacket(payload_type=96, seq=seq, timestamp=seq * 3000,
                             ssrc=0xCA4, payload=bytes(((3 << 5) | nal,))
                             + bytes(30)).to_bytes()

    async def on_push(body):
        await _t(pusher.connect(body["IP"], int(body["Port"])))
        await _t(pusher.push_start(body["URL"], push_sdp))
        for i in range(5):
            pusher.push_packet(0, vid(100 + i, nal=5 if i == 0 else 1))
        return True

    dev = device.SimDevice("cam0042", on_push=on_push)
    try:
        await _t(dev.connect("127.0.0.1", srv.port))
        client = device.CmsClient("127.0.0.1", srv.port)
        devs = await _t(client.device_list())
        assert devs[0]["Serial"] == "cam0042" and devs[0]["Online"] == "1"
        ack = await _t(client.get_stream("cam0042"))
        assert ack.error == ep.ERR_OK, ack.body
        url = ack.body["URL"]
        assert url == (f"rtsp://127.0.0.1:{media.rtsp.port}"
                       f"/cam0042/0.sdp")
        await _t(player.connect("127.0.0.1", media.rtsp.port))
        await _t(player.play_start(url))
        first = await player.recv_interleaved(0, timeout=5.0)
        assert rtp.RtpPacket.parse(first).payload[0] & 0x1F == 5
        ptz = await _t(client.ptz("cam0042", "left"))
        assert ptz.error == ep.ERR_OK
        t0 = time.monotonic()
        while not dev.ctrl_log and time.monotonic() - t0 < 5.0:
            await asyncio.sleep(0.01)
        assert dev.ctrl_log[0]["Command"] == "left"
        ack2 = await _t(client.get_stream("cam0042"))
        assert ack2.body["URL"] == url
        snap_url = await _t(dev.post_snapshot("127.0.0.1", srv.port,
                                           b"\xff\xd8fakejpeg\xff\xd9"))
        assert snap_url.startswith(f"file://{tmp_path / 'snaps'}")
        with open(snap_url[7:], "rb") as f:
            assert f.read() == b"\xff\xd8fakejpeg\xff\xd9"
        evs = [r["event"] for r in obs.EVENTS.tail(200)]
        for e in ("cms.rpc", "cms.register", "cms.push_stream"):
            assert e in evs, e
    finally:
        await player.close()
        await dev.close()
        await pusher.close()
        await srv.stop()
        await media.stop()
    assert media.pump_errors == 0


async def test_cms_stop_closes_its_open_connections(tmp_path):
    """A client connection still open when the CMS stops does not hold
    ``stop`` (Python 3.12's ``wait_closed`` waits for every handler's
    connection)."""
    srv = cms.CmsServer(port_redis.InMemoryRedis(), bind_ip="127.0.0.1",
                        snap_dir=str(tmp_path))
    await srv.start()
    reader, writer = await _t(asyncio.open_connection("127.0.0.1",
                                                      srv.port))
    writer.write(b"POST /easycms HTTP/1.1\r\n")     # a request half sent
    await writer.drain()
    t0 = time.monotonic()
    while not srv._conns and time.monotonic() - t0 < 5.0:
        await asyncio.sleep(0.01)
    await asyncio.wait_for(srv.stop(), 5.0)
    assert await asyncio.wait_for(reader.read(), 5.0) == b""
    writer.close()


# ---------------------------------------------------------------- config
def test_cms_keys_read_as_the_reference(tmp_path):
    toml = tmp_path / "c.toml"
    toml.write_text('cms_host = "10.9.8.7"\ncms_port = 10010\n')
    xml = tmp_path / "c.xml"
    xml.write_text(
        '<?xml version ="1.0"?>\n<CONFIGURATION><SERVER>\n'
        '<PREF NAME="rtsp_port" TYPE="UInt16" >10554</PREF></SERVER>\n'
        '<MODULE NAME="EasyCMSModule" >\n'
        '<PREF NAME="cms_ip" >10.1.1.9</PREF>\n'
        '<PREF NAME="cms_port" TYPE="UInt16" >10001</PREF>\n'
        '</MODULE></CONFIGURATION>\n')
    for path, loader, ref_loader in (
            (toml, config.load_toml,
             lambda f: (ref_config.ServerConfig.from_toml(f), [])),
            (xml, config.load_reference_xml,
             ref_config.load_reference_xml)):
        cfg, unmapped = loader(str(path))
        ref_cfg, _ref_unmapped = ref_loader(str(path))
        assert (cfg.cms_host, cfg.cms_port) \
            == (ref_cfg.cms_host, ref_cfg.cms_port)
        assert not any("cms" in e for e in unmapped), unmapped
    assert (cfg.cms_host, cfg.cms_port) == ("10.1.1.9", 10001)
    assert config.ServerConfig().cms_port \
        == ref_config.ServerConfig().cms_port == 10000
    got = config.ServerConfig(cms_port=3).to_dict()
    assert got["cms_port"] == 3 and got["cms_host"] == "127.0.0.1"
