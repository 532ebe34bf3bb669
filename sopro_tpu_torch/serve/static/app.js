// sopro demo client (the PyTorch/CUDA port's server): SPRO framed-PCM streaming playback with TTFA,
// live waveform scope, reference preview, and output transport controls.
// Fresh minimal implementation of the reference demo's capabilities
// (reference: demo/static/app.js — mic/file reference with preview, stream
// parse, TTFA, analyser-driven canvas scope, play/restart/download).

const $ = (id) => document.getElementById(id);
let refId = null;
let refBlob = null;
let abortCtl = null;
let lastWavBlob = null; // finished output as a WAV blob (download/replay)
let livePlayer = null;  // PCMPlayer while a stream is in flight

function setStatus(msg) { $("status").textContent = msg; }
function setStats(msg) { $("stats").textContent = msg; }

function setRefBlob(blob, label) {
  refBlob = blob;
  refId = null;
  $("refStatus").textContent = label;
  const prev = $("refPreview");
  if (blob) {
    prev.src = URL.createObjectURL(blob);
    prev.style.display = "block";
  } else {
    prev.style.display = "none";
  }
}

// ---------- reference: file or mic ----------------------------------------

$("refFile").addEventListener("change", (e) => {
  const f = e.target.files[0] || null;
  setRefBlob(f, f ? `file: ${f.name}` : "");
});

// Mic recordings are decoded client-side and re-encoded as 16-bit WAV before
// upload (the server's stdlib loader reads WAV; raw MediaRecorder webm/ogg
// would need libsndfile server-side — reference does the same,
// demo/static/app.js:946-966). The button toggles: record until the user
// stops (reference behavior), with a 30 s safety cap so an abandoned tab
// does not record forever.
let activeRec = null;
$("recBtn").addEventListener("click", async () => {
  if (activeRec) { activeRec.stop(); return; }
  const stream = await navigator.mediaDevices.getUserMedia({ audio: true });
  const rec = new MediaRecorder(stream);
  const parts = [];
  const t0 = performance.now();
  const timer = setInterval(() => {
    $("refStatus").textContent =
      `recording… ${((performance.now() - t0) / 1000).toFixed(1)}s (click to stop)`;
  }, 200);
  rec.ondataavailable = (e) => parts.push(e.data);
  rec.onstop = async () => {
    clearInterval(timer);
    clearTimeout(cap);
    activeRec = null;
    $("recBtn").textContent = "record mic";
    stream.getTracks().forEach((t) => t.stop());
    try {
      const raw = new Blob(parts, { type: rec.mimeType });
      const ctx = new AudioContext();
      const decoded = await ctx.decodeAudioData(await raw.arrayBuffer());
      const mono = decoded.getChannelData(0);
      const blob = new Blob([encodeWav([mono], decoded.sampleRate)],
                            { type: "audio/wav" });
      blob.name = "ref.wav";
      setRefBlob(blob, `recorded ${decoded.duration.toFixed(1)}s (wav ready)`);
      ctx.close();
    } catch (e) {
      $("refStatus").textContent = `decode failed: ${e}`;
    }
  };
  const cap = setTimeout(() => rec.state !== "inactive" && rec.stop(), 30000);
  rec.start();
  activeRec = rec;
  $("recBtn").textContent = "stop recording";
  $("refStatus").textContent = "recording… (click to stop)";
});

// chunks: array of Float32Array or Int16Array, mono -> 16-bit PCM WAV bytes
function encodeWav(chunks, sr) {
  let total = 0;
  chunks.forEach((c) => (total += c.length));
  const buf = new ArrayBuffer(44 + total * 2);
  const dv = new DataView(buf);
  const writeStr = (off, s) => {
    for (let i = 0; i < s.length; i++) dv.setUint8(off + i, s.charCodeAt(i));
  };
  writeStr(0, "RIFF"); dv.setUint32(4, 36 + total * 2, true);
  writeStr(8, "WAVE"); writeStr(12, "fmt "); dv.setUint32(16, 16, true);
  dv.setUint16(20, 1, true); dv.setUint16(22, 1, true);
  dv.setUint32(24, sr, true); dv.setUint32(28, sr * 2, true);
  dv.setUint16(32, 2, true); dv.setUint16(34, 16, true);
  writeStr(36, "data"); dv.setUint32(40, total * 2, true);
  let off = 44;
  chunks.forEach((c) => {
    if (c instanceof Int16Array) {
      for (let i = 0; i < c.length; i++, off += 2) dv.setInt16(off, c[i], true);
    } else {
      for (let i = 0; i < c.length; i++, off += 2) {
        const s = Math.max(-1, Math.min(1, c[i]));
        dv.setInt16(off, s < 0 ? s * 32768 : s * 32767, true);
      }
    }
  });
  return buf;
}

$("cacheBtn").addEventListener("click", async () => {
  if (!refBlob) { $("refStatus").textContent = "pick or record audio first"; return; }
  const fd = new FormData();
  fd.append("ref_audio", refBlob, refBlob.name || "ref.wav");
  const rs = $("refSeconds").value;
  if (rs) fd.append("ref_seconds", rs);
  const r = await fetch("/v1/reference/cache", { method: "POST", body: fd });
  if (!r.ok) { $("refStatus").textContent = `cache failed: ${r.status}`; return; }
  const j = await r.json();
  refId = j.ref_id;
  $("refStatus").textContent = `cached ${refId.slice(0, 12)}… (${j.ref_seconds}s)`;
});

// ---------- PCM playback ---------------------------------------------------
// AudioWorklet ring-buffer player for glitch-free low-latency playback
// (reference: demo/static/app.js:130-183); falls back to scheduled
// AudioBufferSource nodes where worklets are unavailable. All output routes
// through an AnalyserNode that feeds the waveform scope.

const WORKLET_SRC = `
class SproRingPlayer extends AudioWorkletProcessor {
  constructor() {
    super();
    this.queue = [];
    this.offset = 0;
    this.port.onmessage = (e) => this.queue.push(e.data);
  }
  process(inputs, outputs) {
    const out = outputs[0][0];
    let i = 0;
    while (i < out.length && this.queue.length) {
      const cur = this.queue[0];
      const n = Math.min(out.length - i, cur.length - this.offset);
      out.set(cur.subarray(this.offset, this.offset + n), i);
      i += n;
      this.offset += n;
      if (this.offset >= cur.length) { this.queue.shift(); this.offset = 0; }
    }
    for (; i < out.length; i++) out[i] = 0;
    return true;
  }
}
registerProcessor("spro-player", SproRingPlayer);
`;

class PCMPlayer {
  constructor(sampleRate) {
    this.ctx = new AudioContext();
    this.srcRate = sampleRate;
    this.nextTime = 0;
    this.node = null;
    this.analyser = this.ctx.createAnalyser();
    this.analyser.fftSize = 2048;
    this.analyser.connect(this.ctx.destination);
    this.ready = this._init();
    scopeAnalyser = this.analyser;
  }
  async _init() {
    if (this.ctx.audioWorklet) {
      try {
        const url = URL.createObjectURL(
          new Blob([WORKLET_SRC], { type: "text/javascript" }));
        await this.ctx.audioWorklet.addModule(url);
        this.node = new AudioWorkletNode(this.ctx, "spro-player",
                                         { outputChannelCount: [1] });
        this.node.connect(this.analyser);
        return;
      } catch (e) { this.node = null; }
    }
    // ScriptProcessor fallback for browsers without AudioWorklet
    // (reference: demo/static/app.js:397); same ring-queue semantics,
    // pulled on the main thread. Last resort: scheduled buffer sources.
    if (typeof this.ctx.createScriptProcessor === "function") {
      try {
        const sp = this.ctx.createScriptProcessor(2048, 0, 1);
        const queue = [];
        let offset = 0;
        sp.onaudioprocess = (e) => {
          const out = e.outputBuffer.getChannelData(0);
          let i = 0;
          while (i < out.length && queue.length) {
            const cur = queue[0];
            const n = Math.min(out.length - i, cur.length - offset);
            out.set(cur.subarray(offset, offset + n), i);
            i += n;
            offset += n;
            if (offset >= cur.length) { queue.shift(); offset = 0; }
          }
          for (; i < out.length; i++) out[i] = 0;
        };
        sp.connect(this.analyser);
        this.node = { port: { postMessage: (f32) => queue.push(f32) } };
      } catch (e) { this.node = null; }
    }
  }
  _resample(int16) {
    const ratio = this.ctx.sampleRate / this.srcRate;
    const outLen = Math.max(Math.floor(int16.length * ratio), 1);
    const out = new Float32Array(outLen);
    for (let i = 0; i < outLen; i++) {
      const pos = i / ratio;
      const i0 = Math.floor(pos), i1 = Math.min(i0 + 1, int16.length - 1);
      const frac = pos - i0;
      out[i] = ((1 - frac) * int16[i0] + frac * int16[i1]) / 32768;
    }
    return out;
  }
  async push(int16) {
    await this.ready;
    const f32 = this._resample(int16);
    if (this.node) {
      this.node.port.postMessage(f32, [f32.buffer]);
      return;
    }
    const buf = this.ctx.createBuffer(1, f32.length, this.ctx.sampleRate);
    buf.getChannelData(0).set(f32);
    const src = this.ctx.createBufferSource();
    src.buffer = buf;
    src.connect(this.analyser);
    const t = Math.max(this.nextTime, this.ctx.currentTime + 0.02);
    src.start(t);
    this.nextTime = t + buf.duration;
  }
  pause() { return this.ctx.suspend(); }
  resume() { return this.ctx.resume(); }
  close() {
    if (scopeAnalyser === this.analyser) scopeAnalyser = null;
    this.ctx.close();
  }
}

// ---------- waveform scope --------------------------------------------------
// Time-domain trace of whatever analyser is live: the streaming PCMPlayer
// while a request is in flight, or the <audio> replay element afterwards.

let scopeAnalyser = null;
let playerElemAnalyser = null; // lazily-built chain for the <audio> element
let scopeStarted = false;

function startScope() {
  if (scopeStarted) return;
  scopeStarted = true;
  const canvas = $("scope");
  const g = canvas.getContext("2d", { alpha: false });
  const data = new Uint8Array(2048);

  function resize() {
    const dpr = Math.max(1, Math.min(2, window.devicePixelRatio || 1));
    const rect = canvas.getBoundingClientRect();
    canvas.width = Math.floor(rect.width * dpr);
    canvas.height = Math.floor(rect.height * dpr);
    g.setTransform(dpr, 0, 0, dpr, 0, 0);
  }
  resize();
  window.addEventListener("resize", resize);

  function draw() {
    requestAnimationFrame(draw);
    const w = canvas.getBoundingClientRect().width;
    const h = canvas.getBoundingClientRect().height;
    g.fillStyle = "#000";
    g.fillRect(0, 0, w, h);
    g.strokeStyle = "#234";
    g.lineWidth = 1;
    g.beginPath(); g.moveTo(0, h / 2); g.lineTo(w, h / 2); g.stroke();
    const a = scopeAnalyser;
    if (!a) return;
    a.getByteTimeDomainData(data);
    g.strokeStyle = "#6cf";
    g.lineWidth = 1.5;
    g.beginPath();
    for (let i = 0; i < data.length; i++) {
      const x = (i / (data.length - 1)) * w;
      const y = (1 - data[i] / 255) * h;
      if (i === 0) g.moveTo(x, y); else g.lineTo(x, y);
    }
    g.stroke();
  }
  draw();
}

function scopeFollowPlayerElem() {
  // route the replay <audio> element through an analyser so the scope keeps
  // drawing after the stream finishes
  const el = $("player");
  if (!playerElemAnalyser) {
    const ctx = new AudioContext();
    const src = ctx.createMediaElementSource(el);
    const an = ctx.createAnalyser();
    an.fftSize = 2048;
    src.connect(an);
    an.connect(ctx.destination);
    playerElemAnalyser = { ctx, an };
  }
  playerElemAnalyser.ctx.resume();
  scopeAnalyser = playerElemAnalyser.an;
}

// ---------- output transport -----------------------------------------------

function setOutput(wavBlob) {
  lastWavBlob = wavBlob;
  const player = $("player");
  player.src = URL.createObjectURL(wavBlob);
  player.style.display = "block";
  $("playBtn").disabled = false;
  $("restartBtn").disabled = false;
  $("downloadBtn").disabled = false;
  $("playBtn").textContent = "play";
}

$("playBtn").addEventListener("click", async () => {
  const btn = $("playBtn");
  if (livePlayer) { // stream in flight: pause/resume the live context
    if (livePlayer.ctx.state === "running") {
      await livePlayer.pause(); btn.textContent = "resume";
    } else {
      await livePlayer.resume(); btn.textContent = "pause";
    }
    return;
  }
  const player = $("player");
  if (player.paused) {
    scopeFollowPlayerElem();
    await player.play(); btn.textContent = "pause";
  } else {
    player.pause(); btn.textContent = "play";
  }
});

$("restartBtn").addEventListener("click", async () => {
  const player = $("player");
  player.currentTime = 0;
  scopeFollowPlayerElem();
  await player.play();
  $("playBtn").textContent = "pause";
});

$("downloadBtn").addEventListener("click", () => {
  if (!lastWavBlob) return;
  const a = document.createElement("a");
  a.href = URL.createObjectURL(lastWavBlob);
  a.download = "sopro.wav";
  a.click();
});

$("player").addEventListener("ended", () => {
  $("playBtn").textContent = "play";
});

// ---------- SPRO stream parsing -------------------------------------------

function concatBytes(a, b) {
  const out = new Uint8Array(a.length + b.length);
  out.set(a, 0); out.set(b, a.length);
  return out;
}

async function speakStream() {
  const fd = buildForm(true);
  if (!fd) return;
  startScope();
  abortCtl = new AbortController();
  $("stopBtn").disabled = false;
  $("speakBtn").disabled = true;
  const t0 = performance.now();
  let ttfa = null, samples = 0, sr = 24000;
  const allPcm = [];
  setStatus("requesting…");
  try {
    const r = await fetch("/v1/audio/speech", {
      method: "POST", body: fd, signal: abortCtl.signal,
    });
    if (!r.ok) { setStatus(`error ${r.status}: ${await r.text()}`); return; }
    const reader = r.body.getReader();
    let buf = new Uint8Array(0);
    let gotHeader = false;
    for (;;) {
      const { value, done } = await reader.read();
      if (done) break;
      buf = concatBytes(buf, value);
      if (!gotHeader && buf.length >= 12) {
        const magic = new TextDecoder().decode(buf.slice(0, 4));
        if (magic !== "SPRO") { setStatus("bad stream magic"); return; }
        const dv = new DataView(buf.buffer, buf.byteOffset + 4, 8);
        sr = dv.getUint32(0, true);
        livePlayer = new PCMPlayer(sr);
        $("playBtn").disabled = false;
        $("playBtn").textContent = "pause";
        buf = buf.slice(12);
        gotHeader = true;
      }
      while (gotHeader && buf.length >= 4) {
        const n = new DataView(buf.buffer, buf.byteOffset, 4).getUint32(0, true);
        if (buf.length < 4 + n) break;
        const payload = buf.slice(4, 4 + n);
        buf = buf.slice(4 + n);
        const pcm = new Int16Array(payload.buffer, payload.byteOffset, n >> 1);
        if (ttfa === null) {
          ttfa = performance.now() - t0;
          setStats(`TTFA ${ttfa.toFixed(0)} ms`);
        }
        samples += pcm.length;
        allPcm.push(pcm.slice());
        livePlayer.push(pcm);
        setStatus(`streaming… ${(samples / sr).toFixed(1)}s`);
      }
    }
    const wall = (performance.now() - t0) / 1000;
    setStatus(`done: ${(samples / sr).toFixed(1)}s audio`);
    setStats(`TTFA ${ttfa ? ttfa.toFixed(0) : "-"} ms · wall ${wall.toFixed(2)}s · RTF ${(wall / (samples / sr)).toFixed(3)}`);
    setOutput(new Blob([encodeWav(allPcm, sr)], { type: "audio/wav" }));
  } catch (e) {
    if (e.name !== "AbortError") setStatus(`failed: ${e}`);
    else setStatus("stopped");
  } finally {
    $("stopBtn").disabled = true;
    $("speakBtn").disabled = false;
    livePlayer = null; // keep the context draining its tail, scope follows
  }
}

async function speakWav() {
  const fd = buildForm(false);
  if (!fd) return;
  startScope();
  setStatus("synthesizing…");
  const t0 = performance.now();
  const r = await fetch("/v1/audio/speech", { method: "POST", body: fd });
  if (!r.ok) { setStatus(`error ${r.status}: ${await r.text()}`); return; }
  const blob = await r.blob();
  const wall = (performance.now() - t0) / 1000;
  setOutput(blob);
  scopeFollowPlayerElem();
  const player = $("player");
  player.play();
  $("playBtn").textContent = "pause";
  setStatus(`wav ready (${(blob.size / 1024).toFixed(0)} KiB)`);
  setStats(`wall ${wall.toFixed(2)}s`);
}

function buildForm(stream) {
  const text = $("text").value.trim();
  if (!text) { setStatus("enter text"); return null; }
  const fd = new FormData();
  fd.append("input", text);
  fd.append("stream", stream ? "true" : "false");
  fd.append("top_p", $("topP").value);
  fd.append("temperature", $("temp").value);
  fd.append("style_strength", $("style").value);
  fd.append("max_frames", $("maxFrames").value);
  fd.append("seed", $("seed").value || "0");
  fd.append("anti_loop", $("antiLoop").checked ? "true" : "false");
  const rs = $("refSeconds").value;
  if (rs) fd.append("ref_seconds", rs);
  if (refId) fd.append("ref_id", refId);
  else if (refBlob) fd.append("ref_audio", refBlob, refBlob.name || "ref.wav");
  else { setStatus("cache or attach a reference first"); return null; }
  return fd;
}

$("speakBtn").addEventListener("click", speakStream);
$("wavBtn").addEventListener("click", speakWav);
$("stopBtn").addEventListener("click", () => abortCtl && abortCtl.abort());
startScope();
