/* GPU Image Processing frontend.
 *
 * Talks to the REST API (server/app.py) with the same JSON contract as the
 * reference stack; charts are drawn directly on <canvas> (no CDN deps).
 * Always requests /api/process-all with deep profiling optional.
 */

/* Backend location: same host, port 8000 (reference frontend/js/app.js:2
 * contract).  `?api=http://host:port` overrides it so one built frontend
 * can point at a staging/alternate backend without an edit.
 *
 * The override is restricted to http(s) URLs on the SAME hostname (any
 * port): a crafted link (?api=https://evil.example) would otherwise make
 * the page silently POST the user's uploaded image to an arbitrary
 * origin.  Cross-host overrides are dropped with a console warning. */
function resolveApiBase() {
  const fallback = `${location.protocol}//${location.hostname}:8000`;
  const override = new URLSearchParams(location.search).get("api");
  if (!override) return fallback;
  try {
    const u = new URL(override, location.href);
    const sameHost =
      u.hostname === location.hostname ||
      // file:// pages have an empty hostname; allow loopback there.
      (!location.hostname && ["localhost", "127.0.0.1"].includes(u.hostname));
    if (["http:", "https:"].includes(u.protocol) && sameHost) {
      console.warn(`API override active: ${u.origin}`);
      return u.origin;
    }
    console.warn(`Ignoring cross-origin ?api= override: ${override}`);
  } catch (e) {
    console.warn(`Ignoring malformed ?api= override: ${override}`);
  }
  return fallback;
}
const API_BASE = resolveApiBase();

const $ = (id) => document.getElementById(id);
const state = { imageB64: null, lightboxItems: [], lightboxIdx: 0 };

/* ------------------------------------------------------------------ setup */

window.addEventListener("DOMContentLoaded", () => {
  checkHealth();
  setupDropzone();
  setupControls();
  setupLightbox();
});

async function checkHealth() {
  const el = $("health");
  try {
    const r = await fetch(`${API_BASE}/api/health`);
    if (!r.ok) {
      // A non-200 is a server error, not an accelerator-capacity state.
      el.textContent = `backend: error (HTTP ${r.status})`;
      el.className = "health bad";
      return;
    }
    const body = await r.json();
    const ok = body.status === "healthy" && body.gpu_available;
    el.textContent = ok ? "backend: GPU ready" : "backend: accelerator unavailable";
    el.className = `health ${ok ? "ok" : "bad"}`;
  } catch {
    el.textContent = "backend: offline";
    el.className = "health bad";
  }
}

function setupDropzone() {
  const dz = $("dropzone");
  const input = $("fileInput");
  dz.addEventListener("click", () => input.click());
  // tabindex=0 promises keyboard operability: Enter/Space open the picker.
  dz.addEventListener("keydown", (e) => {
    if (e.key === "Enter" || e.key === " ") {
      e.preventDefault();
      input.click();
    }
  });
  dz.addEventListener("dragover", (e) => { e.preventDefault(); dz.classList.add("drag"); });
  dz.addEventListener("dragleave", () => dz.classList.remove("drag"));
  dz.addEventListener("drop", (e) => {
    e.preventDefault();
    dz.classList.remove("drag");
    if (e.dataTransfer.files.length) loadFile(e.dataTransfer.files[0]);
  });
  input.addEventListener("change", () => {
    if (input.files.length) loadFile(input.files[0]);
  });
}

function loadFile(file) {
  if (!file.type.startsWith("image/")) return showError("Please choose an image file.");
  const reader = new FileReader();
  reader.onerror = () =>
    showError(`Could not read ${file.name}: ${reader.error?.message || "file unreadable"}`);
  reader.onload = () => {
    state.imageB64 = reader.result; // data URL
    const dz = $("dropzone");
    // Keep #fileInput in the DOM (innerHTML = "" would detach it and kill
    // click-to-browse) and reset it so re-picking the SAME file re-fires
    // the change event.
    dz.querySelectorAll("p, img.preview, .hint").forEach((el) => el.remove());
    const inp = $("fileInput");
    if (inp) inp.value = "";
    const img = document.createElement("img");
    img.src = state.imageB64;
    img.className = "preview";
    const p = document.createElement("p");
    p.textContent = file.name;
    dz.append(p, img);
    $("processBtn").disabled = false;
    hideError();
  };
  reader.readAsDataURL(file);
}

function setupControls() {
  $("sigma").addEventListener("input", () => ($("sigmaVal").textContent = $("sigma").value));
  $("radius").addEventListener("input", () => ($("radiusVal").textContent = $("radius").value));
  $("filterSelect").addEventListener("change", () => {
    const f = $("filterSelect").value;
    $("sigmaField").hidden = f !== "gaussian";
    $("radiusField").hidden = f === "sobel";
  });
  $("processBtn").addEventListener("click", processImage);
}

/* -------------------------------------------------------------- processing */

async function processImage() {
  if (!state.imageB64) return;
  const payload = {
    image: state.imageB64,
    filter: $("filterSelect").value,
    sigma: parseFloat($("sigma").value),
    radius: parseInt($("radius").value, 10),
    enable_profiling: $("profiling").checked,
  };
  $("processBtn").disabled = true;
  $("spinner").hidden = false;
  hideError();
  try {
    const r = await fetch(`${API_BASE}/api/process-all`, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(payload),
    });
    const body = await r.json();
    if (!r.ok) throw new Error(body.detail || `HTTP ${r.status}`);
    renderResults(body, payload.filter);
  } catch (err) {
    showError(`Processing failed: ${err.message}`);
  } finally {
    $("processBtn").disabled = false;
    $("spinner").hidden = true;
  }
}

function levelLabel(key, info) {
  return `Level ${info.level_number ?? key.split("_")[1]} — ${info.level}`;
}

function renderResults(body, filterName) {
  $("results").hidden = false;
  const grid = $("imageGrid");
  grid.innerHTML = "";
  state.lightboxItems = [];

  addImageCard(grid, body.original_image, "Original",
    `${body.image_info.width}×${body.image_info.height}`);
  const levels = Object.keys(body.results).sort();
  for (const key of levels) {
    const r = body.results[key];
    addImageCard(grid, r.processed_image, levelLabel(key, r.info),
      `${r.metrics.time_ms.toFixed(3)} ms`);
  }

  renderSpeedup(body.results);
  renderCharts(body.results, body.image_info);
  renderMetricsTable(body.results);
}

function addImageCard(grid, src, title, sub) {
  const card = document.createElement("div");
  card.className = "imgcard";
  const img = document.createElement("img");
  img.src = src;
  img.alt = title;
  const idx = state.lightboxItems.length;
  state.lightboxItems.push({ src, title });
  img.addEventListener("click", () => openLightbox(idx));
  const cap = document.createElement("div");
  cap.className = "caption";
  // title carries server-supplied strings (info.level) -- never innerHTML
  const b = document.createElement("b");
  b.textContent = title;
  const span = document.createElement("span");
  span.textContent = sub;
  cap.append(b, span);
  card.append(img, cap);
  grid.append(card);
}

/* Speedup is always computed from the real device-event time_ms, never from
 * profiled time (the reference enforces the same invariant). */
function renderSpeedup(results) {
  const badge = $("speedupBadge");
  const l1 = results.level_1, l2 = results.level_2;
  if (l1 && l2 && l2.metrics.time_ms > 0 && l1.metrics.time_ms > 0) {
    const s = l1.metrics.time_ms / l2.metrics.time_ms;
    // Print the factor in the direction named: "0.50x slower" is wrong
    // when the true slowdown is 2.00x.
    badge.textContent = s >= 1
      ? `Level 2 is ${s.toFixed(2)}× faster`
      : `Level 2 is ${(1 / s).toFixed(2)}× slower`;
    badge.hidden = false;
  } else {
    badge.hidden = true;
  }
}

/* ------------------------------------------------------------------ charts */

function renderCharts(results, imageInfo) {
  const labels = [], times = [], bws = [];
  for (const key of Object.keys(results).sort()) {
    const r = results[key];
    labels.push(levelLabel(key, r.info));
    times.push(r.metrics.time_ms);
    let bw = r.metrics.bandwidth_gbps;
    if (!bw && r.metrics.time_ms > 0) {
      const bytes = imageInfo.width * imageInfo.height * imageInfo.channels * 4;
      bw = bytes / (r.metrics.time_ms / 1000) / 1024 ** 3;
    }
    bws.push(bw);
  }
  barChart($("timeChart"), "Execution time (ms)", labels, times, "#4f8cff");
  barChart($("bwChart"), "Effective bandwidth (GB/s)", labels, bws, "#34d399");
}

function barChart(canvas, title, labels, values, color) {
  // `hidden` survives re-renders of the same canvas (Chart.js keeps the
  // legend toggle state across chart updates the same way).
  const hidden = canvas._chart ? canvas._chart.hidden : false;
  canvas._chart = { title, labels, values, color, rects: [], hidden, legendRect: null };
  canvas._hoverIdx = -1;
  drawBarChart(canvas, -1);
  bindChartHover(canvas);
}

function drawBarChart(canvas, hoverIdx) {
  const { title, labels, values, color, hidden } = canvas._chart;
  const ctx = canvas.getContext("2d");
  const W = canvas.width, H = canvas.height;
  const padL = 56, padR = 16, padT = 34, padB = 44;
  ctx.clearRect(0, 0, W, H);

  ctx.fillStyle = "#e8edf6";
  ctx.font = "600 13px system-ui";
  ctx.fillText(title, padL, 20);

  // Legend (Chart.js default parity: one item per dataset; clicking it
  // toggles the dataset's visibility, struck through while hidden).
  ctx.font = "11px system-ui";
  const legendText = title.replace(/\s*\([^)]*\)$/, "");
  const lw = ctx.measureText(legendText).width;
  const lx = W - padR - lw - 16, ly = 13;
  canvas._chart.legendRect = { x: lx - 4, y: ly - 9, w: lw + 24, h: 16 };
  ctx.fillStyle = color;
  ctx.fillRect(lx, ly - 6, 10, 10);
  ctx.fillStyle = hidden ? "#8a97ad" : "#e8edf6";
  ctx.fillText(legendText, lx + 14, ly + 3);
  if (hidden) {
    ctx.strokeStyle = "#8a97ad";
    ctx.beginPath();
    ctx.moveTo(lx + 13, ly - 1);
    ctx.lineTo(lx + 15 + lw, ly - 1);
    ctx.stroke();
  }

  const max = Math.max(...values, 1e-9);
  const innerW = W - padL - padR, innerH = H - padT - padB;
  const n = values.length;
  const slot = innerW / n;
  const barW = Math.min(90, slot * 0.55);

  // gridlines + y labels
  ctx.strokeStyle = "#2b3750";
  ctx.fillStyle = "#8a97ad";
  ctx.font = "11px system-ui";
  const steps = 4;
  for (let i = 0; i <= steps; i++) {
    const v = (max * i) / steps;
    const y = padT + innerH - (innerH * i) / steps;
    ctx.beginPath();
    ctx.moveTo(padL, y);
    ctx.lineTo(W - padR, y);
    ctx.stroke();
    ctx.fillText(fmtNum(v), 6, y + 4);
  }

  canvas._chart.rects = [];
  values.forEach((v, i) => {
    const h = (v / max) * innerH;
    const x = padL + slot * i + (slot - barW) / 2;
    const y = padT + innerH - h;
    if (!hidden) {
      canvas._chart.rects.push({ x, y, w: barW, h });
      ctx.fillStyle = color;
      ctx.fillRect(x, y, barW, h);
      if (i === hoverIdx) {
        // hover highlight: brighten the bar and outline it
        ctx.fillStyle = "rgba(255,255,255,0.25)";
        ctx.fillRect(x, y, barW, h);
        ctx.strokeStyle = "#e8edf6";
        ctx.strokeRect(x + 0.5, y + 0.5, barW - 1, h - 1);
      }
      ctx.fillStyle = "#e8edf6";
      ctx.font = "11px system-ui";
      ctx.fillText(fmtNum(v), x, y - 5);
    }
    ctx.fillStyle = "#8a97ad";
    ctx.font = "11px system-ui";
    wrapText(ctx, labels[i], x - (slot - barW) / 2, H - padB + 14, slot, 12);
  });
}

/* Hover tooltips on the canvas bars (the reference gets these from
 * Chart.js; here they are hand-rolled on the same shared tooltip div). */
function bindChartHover(canvas) {
  if (canvas._hoverBound) return;
  canvas._hoverBound = true;
  canvas.addEventListener("mousemove", (e) => {
    const r = canvas.getBoundingClientRect();
    // CSS size can differ from the bitmap size; map into bitmap coords.
    const x = (e.clientX - r.left) * (canvas.width / r.width);
    const y = (e.clientY - r.top) * (canvas.height / r.height);
    const hit = hitTestBars(canvas._chart.rects, x, y);
    if (hit !== canvas._hoverIdx) {
      canvas._hoverIdx = hit;
      drawBarChart(canvas, hit);
    }
    const onLegend = hitLegend(canvas._chart.legendRect, x, y);
    canvas.style.cursor = hit >= 0 || onLegend ? "pointer" : "default";
    moveChartTip(canvas, e, hit);
  });
  canvas.addEventListener("click", (e) => {
    const r = canvas.getBoundingClientRect();
    const x = (e.clientX - r.left) * (canvas.width / r.width);
    const y = (e.clientY - r.top) * (canvas.height / r.height);
    if (hitLegend(canvas._chart.legendRect, x, y)) {
      canvas._chart.hidden = !canvas._chart.hidden;
      canvas._hoverIdx = -1;
      chartTip().hidden = true;
      drawBarChart(canvas, -1);
    }
  });
  canvas.addEventListener("mouseleave", () => {
    if (canvas._hoverIdx !== -1) {
      canvas._hoverIdx = -1;
      drawBarChart(canvas, -1);
    }
    chartTip().hidden = true;
  });
}

function hitLegend(rect, x, y) {
  return !!rect && x >= rect.x && x <= rect.x + rect.w &&
         y >= rect.y && y <= rect.y + rect.h;
}

function hitTestBars(rects, x, y) {
  for (let i = 0; i < rects.length; i++) {
    const b = rects[i];
    // include the value label strip above the bar so short bars are easy
    // to hit
    if (x >= b.x && x <= b.x + b.w && y >= b.y - 18 && y <= b.y + b.h)
      return i;
  }
  return -1;
}

function chartTip() {
  let tip = $("chartTip");
  if (!tip) {
    tip = document.createElement("div");
    tip.id = "chartTip";
    tip.className = "chart-tip";
    tip.hidden = true;
    document.body.append(tip);
  }
  return tip;
}

function moveChartTip(canvas, e, hit) {
  const tip = chartTip();
  if (hit < 0) {
    tip.hidden = true;
    return;
  }
  const c = canvas._chart;
  const unit = (c.title.match(/\(([^)]+)\)$/) || [])[1] || "";
  // labels carry server-supplied level names -- assign text, not markup
  tip.textContent = `${c.labels[hit]}: ${fmtNum(c.values[hit])}${unit ? " " + unit : ""}`;
  tip.hidden = false;
  tip.style.left = `${e.pageX + 12}px`;
  tip.style.top = `${e.pageY - 30}px`;
}

function wrapText(ctx, text, x, y, maxWidth, lineH) {
  const words = text.split(" ");
  let line = "", yy = y;
  for (const w of words) {
    const trial = line ? `${line} ${w}` : w;
    if (ctx.measureText(trial).width > maxWidth && line) {
      ctx.fillText(line, x, yy);
      line = w;
      yy += lineH;
    } else line = trial;
  }
  ctx.fillText(line, x, yy);
}

function fmtNum(v) {
  if (v === null || v === undefined || Number.isNaN(v)) return "—";
  if (v === 0) return "0";  // not "0.0e+0"
  if (v >= 1000) return v.toFixed(0);
  if (v >= 10) return v.toFixed(1);
  if (v >= 0.01) return v.toFixed(3);
  return v.toExponential(1);
}

/* ----------------------------------------------------------- metrics table */

/* Categorized sections mirroring the reference UI's ~7-category ncu view
 * (frontend/js/app.js:371-581 there): Execution / per-kernel rows /
 * Memory / Occupancy / Configuration, plus a generic Other section that
 * sweeps up any profiler-dict entry not explicitly mapped, so the WHOLE
 * deep-profile dict always reaches the table. */
const METRIC_SECTIONS = [
  ["Execution", ["time_ms", "ncu_profiled_time_ms", "kernel_duration_ms",
                 "kernel_duration_source", "fps",
                 "total_kernels", "compute_throughput_pct",
                 "profiling_error"]],
  ["Memory", ["bandwidth_gbps", "memory_throughput_gbps", "io_throughput_gbps",
              "hlo_bytes_accessed", "dram_throughput_pct",
              "peak_device_memory_bytes", "temp_buffer_bytes",
              "argument_bytes", "output_bytes"]],
  ["Occupancy", ["occupancy_pct"]],
  ["Configuration", ["image_shape", "platform", "device", "hlo_flops",
                     "peak_hbm_gbps"]],
];
const IMPORTANT = new Set(["time_ms", "bandwidth_gbps", "fps",
                           "dram_throughput_pct"]);
const LABELS = {
  time_ms: "Execution time (ms)",
  ncu_profiled_time_ms: "Profiled kernel time (ms)",
  kernel_duration_ms: "Kernel duration (ms)",
  kernel_duration_source: "Duration source",
  fps: "Throughput (fps)",
  total_kernels: "Kernels profiled",
  compute_throughput_pct: "Compute throughput (% peak)",
  bandwidth_gbps: "Modeled bandwidth (GB/s)",
  memory_throughput_gbps: "Measured memory throughput (GB/s)",
  io_throughput_gbps: "Image IO throughput (GB/s)",
  hlo_bytes_accessed: "HLO bytes accessed",
  dram_throughput_pct: "HBM utilization (%)",
  peak_device_memory_bytes: "Peak device memory (bytes)",
  temp_buffer_bytes: "Temp buffer (bytes)",
  argument_bytes: "Argument buffers (bytes)",
  output_bytes: "Output buffers (bytes)",
  occupancy_pct: "Bandwidth occupancy (%)",
  image_shape: "Image shape",
  platform: "Platform",
  device: "Device",
  hlo_flops: "HLO FLOPs",
  peak_hbm_gbps: "Peak HBM bandwidth (GB/s)",
};
/* Honest provenance labels for the per-kernel duration rows (round-1
 * presented estimates as measurements; the source tag fixes that). */
const SOURCE_LABELS = {
  xplane_trace: "measured (device trace)",
  isolated_pass_estimate: "estimated (isolated passes)",
  device_timing: "device timing (no breakdown)",
};

/* Deep-profile dict (ncu_data) -> flat UI keys.  Anything in the deep
 * sections NOT named here lands in the generic Other section. */
const DEEP_KEY_MAP = {
  "IO Throughput (Gbyte/s)": "io_throughput_gbps",
  "HLO Bytes Accessed": "hlo_bytes_accessed",
  "Temp Buffer Bytes": "temp_buffer_bytes",
  "Argument Bytes": "argument_bytes",
  "Output Bytes": "output_bytes",
  "Image Shape": "image_shape",
  "Platform": "platform",
  "Device": "device",
  "HLO FLOPs": "hlo_flops",
  "Peak HBM Bandwidth (Gbyte/s)": "peak_hbm_gbps",
};
/* Deep entries that would duplicate a primary row are suppressed, keeping
 * the never-override-time_ms invariant visible in the UI as well. */
const DEEP_SUPPRESS = new Set([
  "Duration (ms)", "Mean Duration (ms)", "Launch Count",
  "Memory Throughput (Gbyte/s)", "DRAM Throughput (% of peak)",
  "Achieved Occupancy (% of peak HBM bandwidth)",
  "Compute Throughput (% of peak f32)",
  "Peak Device Memory (bytes)",
]);

/* Expand the profiler's per-kernel duration lists (kernel_durations +
 * kernels_profiled: trace-derived device kernels, or the separable blur's
 * horizontal/vertical split) into scalar rows, like the reference's
 * per-kernel ncu Duration rows -- labeled with their provenance. */
function expandPassDurations(m, labels) {
  const out = { ...m };
  const est = m.kernel_duration_source === "isolated_pass_estimate";
  if (Array.isArray(m.kernel_durations) && m.kernel_durations.length > 1 &&
      Array.isArray(m.kernels_profiled)) {
    m.kernel_durations.forEach((v, i) => {
      const name = String(m.kernels_profiled[i] || `kernel ${i}`);
      const pass = name.match(/(horizontal|vertical)$/);
      const unit = est ? "est. ms" : "ms";
      // Key rows by (kernel name, unit), NOT index: levels with different
      // kernel sets (estimated passes vs trace kernels) must land on
      // separate rows, not overwrite each other's shared label.
      const key = `kpass:${name} (${unit})`;
      out[key] = v;
      labels[key] = `└ ${pass ? pass[1] + " pass" : name} (${unit})`;
    });
  }
  return out;
}

/* Pull extra deep-profile entries (ncu_data sections) into flat keys; the
 * unmapped remainder goes to an Other map rendered generically. */
function flattenDeep(m, other) {
  const out = { ...m };
  const deep = m.ncu_data;
  if (!deep || typeof deep !== "object") return out;
  for (const section of ["execution", "memory", "occupancy", "config"]) {
    const entries = deep[section];
    if (!entries || typeof entries !== "object") continue;
    for (const [name, v] of Object.entries(entries)) {
      if (v === null || v === undefined || DEEP_SUPPRESS.has(name)) continue;
      const key = DEEP_KEY_MAP[name];
      if (key) {
        if (out[key] === undefined) out[key] = v;
      } else if (!name.startsWith("Duration ")) {
        other[name] = true;
        out[`other:${name}`] = v;
      }
    }
  }
  if (out.kernel_duration_source) {
    out.kernel_duration_source =
      SOURCE_LABELS[out.kernel_duration_source] || out.kernel_duration_source;
  }
  return out;
}

function renderMetricsTable(results) {
  const host = $("metricsTable");
  const levels = Object.keys(results).sort();
  const dynLabels = {};
  const otherNames = {};
  const metricsByLevel = {};
  for (const lv of levels) {
    metricsByLevel[lv] =
      flattenDeep(expandPassDurations(results[lv].metrics, dynLabels), otherNames);
  }
  let html = "<table class='metrics'><tr><th>Metric</th>";
  for (const key of levels) html += `<th>${escapeHtml(levelLabel(key, results[key].info))}</th>`;
  html += "</tr>";

  const sections = METRIC_SECTIONS.map(([s, keys]) => [s, keys]);
  const otherKeys = Object.keys(otherNames).sort().map((n) => `other:${n}`);
  if (otherKeys.length) sections.push(["Other", otherKeys]);

  for (const [section, keys] of sections) {
    let sectionKeys = keys;
    if (section === "Execution") {
      const passKeys = Object.keys(dynLabels).sort();
      const at = keys.indexOf("kernel_duration_ms") + 1;
      sectionKeys = [...keys.slice(0, at), ...passKeys, ...keys.slice(at)];
    }
    const present = sectionKeys.filter((k) =>
      levels.some((lv) => metricsByLevel[lv][k] !== undefined));
    if (!present.length) continue;
    html += `<tr class="section"><td colspan="${levels.length + 1}">${section}</td></tr>`;
    for (const k of present) {
      const star = IMPORTANT.has(k) ? `<span class="star">★</span> ` : "";
      const label = LABELS[k] || dynLabels[k] ||
        (k.startsWith("other:") ? k.slice(6) : k);
      // labels can carry profiler-supplied strings (kernel names, device
      // notes) -- escape them like the value cells
      html += `<tr><td>${star}${escapeHtml(label)}</td>`;
      for (const lv of levels) {
        const v = metricsByLevel[lv][k];
        html += `<td class="num ${pctClass(k, v)}">${fmtVal(v)}</td>`;
      }
      html += "</tr>";
    }
  }
  html += "</table>";
  host.innerHTML = html;
}

function fmtVal(v) {
  if (typeof v === "number") return fmtNum(v);
  if (v === null || v === undefined) return "—";
  return escapeHtml(String(v));
}

function escapeHtml(s) {
  return s.replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;");
}

function pctClass(key, v) {
  if (!(key.endsWith("_pct") || key.includes("(%")) || typeof v !== "number")
    return "";
  if (v >= 60) return "pct-good";
  if (v >= 25) return "pct-mid";
  return "pct-low";
}

/* --------------------------------------------------------------- lightbox */

function setupLightbox() {
  $("lbClose").addEventListener("click", closeLightbox);
  $("lbPrev").addEventListener("click", () => stepLightbox(-1));
  $("lbNext").addEventListener("click", () => stepLightbox(1));
  $("lightbox").addEventListener("click", (e) => {
    if (e.target === $("lightbox")) closeLightbox();
  });
  document.addEventListener("keydown", (e) => {
    if ($("lightbox").hidden) return;
    if (e.key !== "Escape" && e.key !== "ArrowLeft" && e.key !== "ArrowRight")
      return;
    e.preventDefault();  // don't also scroll the page behind the overlay
    if (e.key === "Escape") closeLightbox();
    if (e.key === "ArrowLeft") stepLightbox(-1);
    if (e.key === "ArrowRight") stepLightbox(1);
  });
}

function openLightbox(idx) {
  state.lightboxIdx = idx;
  const item = state.lightboxItems[idx];
  $("lbImg").src = item.src;
  $("lbCaption").textContent = item.title;
  $("lightbox").hidden = false;
}

function stepLightbox(d) {
  const n = state.lightboxItems.length;
  openLightbox(((state.lightboxIdx + d) % n + n) % n);
}

function closeLightbox() {
  $("lightbox").hidden = true;
}

/* ------------------------------------------------------------------ errors */

function showError(msg) {
  $("error").textContent = msg;
  $("error").hidden = false;
}
function hideError() {
  $("error").hidden = true;
}
