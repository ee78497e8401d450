// Service worker: offline app shell for the streaming spectrogram PWA.
// Capability parity with the reference's worker (web-spectrogram/sw.js:
// precache shell, cache-first fetch), extended with versioned cache
// cleanup and a stale-while-revalidate policy for shell assets so
// updates propagate without breaking offline use. API POSTs are never
// cached (streaming frames are stateful).
const CACHE = "kofft-spectrogram-v3";
const SHELL = [
  "./",
  "./index.html",
  "./app.mjs",
  "./local.mjs",
  "./manifest.webmanifest",
];

self.addEventListener("install", (event) => {
  event.waitUntil(
    caches.open(CACHE).then((c) => c.addAll(SHELL)).then(
      () => self.skipWaiting()),
  );
});

self.addEventListener("activate", (event) => {
  // drop caches from older versions
  event.waitUntil(
    caches.keys().then((keys) =>
      Promise.all(keys.filter((k) => k !== CACHE)
        .map((k) => caches.delete(k)))).then(() => self.clients.claim()),
  );
});

self.addEventListener("fetch", (event) => {
  const req = event.request;
  if (req.method !== "GET") return;           // never cache API POSTs
  const url = new URL(req.url);
  if (url.pathname.startsWith("/api/") || url.pathname === "/health") {
    return;                                    // live endpoints: network only
  }
  // stale-while-revalidate: serve cached shell instantly, refresh behind.
  // The refresh is registered with waitUntil so the browser keeps the
  // worker alive until the background fetch AND cache.put complete —
  // otherwise an idle-kill right after respondWith would abort the
  // update and the shell would stay stale forever while online.
  event.respondWith(
    caches.match(req).then((hit) => {
      const refresh = fetch(req).then(async (resp) => {
        if (resp && resp.ok) {
          const c = await caches.open(CACHE);
          await c.put(req, resp.clone());
        }
        return resp;
        // offline: fall back to the cache hit; on a cache MISS resolve
        // to a network-error Response (undefined would make respondWith
        // throw "Failed to convert value to Response")
      }).catch(() => hit || Response.error());
      event.waitUntil(refresh);
      return hit || refresh;
    }),
  );
});
